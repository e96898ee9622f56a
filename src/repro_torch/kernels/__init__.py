"""Hand-written CUDA kernels for Hopper (sm_90a), one subpackage each.

Each subpackage holds ``csrc/<name>.cu`` (the kernel, with a plain C
entry point), ``ops.py`` (the wrapper: launches the kernel on a CUDA
tensor, runs the plain version on a CPU tensor, counts launches) and
``ref.py`` (the plain PyTorch version).  ``_build.py`` compiles the
sources with nvcc on first use.
"""
