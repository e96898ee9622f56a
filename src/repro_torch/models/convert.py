"""Parameters from the reference's trees, so both packages compute the same
thing.

``params_from_numpy(cfg, tree)`` takes the JAX family's parameter pytree
with every leaf converted to a numpy array (layers stacked on axis 0, the
reference's layout) and returns the port's tree of tensors, checked leaf
by leaf against the port's :func:`param_specs`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from . import registry
from .common import ParamSpec


def params_from_numpy(cfg: ArchConfig, tree: dict, device=None) -> dict:
    """numpy tree (reference layout) -> tensor tree on ``device`` (the
    card unless ``"cpu"`` is passed; see :func:`resolve_device`).

    Raises if a leaf is missing, extra, or of another shape than the
    port's spec.  bf16 leaves (``ml_dtypes``) go through fp32, which is
    exact."""
    device = resolve_device(device)
    specs = registry.get_module(cfg).param_specs(cfg)

    def walk(spec, node, path):
        if isinstance(spec, ParamSpec):
            arr = np.asarray(node)
            if tuple(arr.shape) != tuple(spec.shape):
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != "
                                 f"spec {spec.shape}")
            if arr.dtype.name == "bfloat16":
                arr = arr.astype(np.float32)
            return torch.tensor(arr, dtype=spec.dtype, device=device)
        if not isinstance(node, dict) or set(node) != set(spec):
            got = sorted(node) if isinstance(node, dict) else type(node).__name__
            raise ValueError(f"{'/'.join(path) or 'params'}: keys {got} != "
                             f"spec {sorted(spec)}")
        return {k: walk(spec[k], node[k], path + (k,)) for k in spec}

    return walk(specs, tree, ())
