"""Hand-written CUDA kernels for Hopper (sm_90a), one subpackage each.

Each subpackage holds ``csrc/<name>.cu`` (the kernel, with a plain C
entry point), ``ops.py`` (the wrapper: launches the kernel on a CUDA
tensor, runs the plain version on a CPU tensor, counts launches) and
``ref.py`` (the plain PyTorch version).  ``_build.py`` compiles the
sources with nvcc on first use.
"""


def launch_counters() -> tuple:
    """Every kernel wrapper of the package; each holds its ``.launches``."""
    from .flash_attention.ops import flash_attention
    from .flat_adam.ops import flat_adam
    from .paged_attention.ops import paged_attention
    from .rmsnorm.ops import rmsnorm, rmsnorm_add, rmsnorm_gated
    from .ssd.ops import ssd

    return (flash_attention, paged_attention, rmsnorm, rmsnorm_add, rmsnorm_gated, ssd,
            flat_adam)
