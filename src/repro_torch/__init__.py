"""PyTorch/CUDA port of the ``repro`` package.

The JAX package (``src/repro``) is the reference; this package mirrors its
module names so each module's counterpart is easy to find.  It imports
``torch`` and never ``jax`` or anything of ``repro``: what it needs from
the reference (configs, host-side serve logic) is copied here.

Entry points take an explicit ``device``.  Left unset they run on
``cuda`` and raise when no card is present; tests pass ``device="cpu"``,
where every kernel wrapper runs its plain PyTorch version.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
