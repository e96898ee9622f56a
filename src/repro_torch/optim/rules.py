"""Update rules (paper §3.3: the Lasagne rules adapted to multi-device —
SGD, Nesterov momentum, RMSProp, Adam) as pure transforms of parameter
trees (nested dicts of tensors).

States are fp32 regardless of parameter dtype (mixed-precision training).
The reference's ``state_pspecs`` has no counterpart: the port has no
partition specs (the per-parameter path replicates its state).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .flat import tree_from_leaves, tree_leaves

KINDS = ("sgd", "momentum", "rmsprop", "adam", "adamw")


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adam"
    lr: float = 3e-4
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    # loop the adam update over each stacked leaf's layer axis: bounds the
    # live fp32 temporaries of the elementwise chain to one layer's worth
    # (the same numbers as the whole-leaf update)
    chunked: bool = False
    # flat-gradient bucket size (MiB) for the bucketed collective engine
    # (optim/buckets.py); parameter-boundary-aligned greedy partition.
    # "auto" falls back to 4 MiB (see buckets.resolve_bucket_bytes).
    bucket_mb: float | str = 4.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind {self.kind!r} not in {KINDS}")
        if isinstance(self.bucket_mb, str):
            if self.bucket_mb != "auto":
                raise ValueError(
                    f"bucket_mb must be a float (MiB) or 'auto', "
                    f"got {self.bucket_mb!r}"
                )
        elif self.bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be positive, got {self.bucket_mb}")


def map_leaves(fn, *trees) -> dict:
    """``fn`` over the leaves of same-structured trees (sorted-key order)."""
    pairs = [list(tree_leaves(t)) for t in trees]
    paths = [p for p, _ in pairs[0]]
    out = [fn(*(pr[i][1] for pr in pairs)) for i in range(len(paths))]
    return tree_from_leaves(paths, out)


def init_state(cfg: OptConfig, params) -> dict:
    def zeros():
        return map_leaves(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params)

    dev = next(l for _, l in tree_leaves(params)).device
    st: dict[str, Any] = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.kind == "momentum":
        st["m"] = zeros()
    elif cfg.kind == "rmsprop":
        st["v"] = zeros()
    elif cfg.kind in ("adam", "adamw"):
        st["m"] = zeros()
        st["v"] = zeros()
    return st


def global_norm(tree) -> torch.Tensor:
    sq = [x.float().square().sum() for _, x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return map_leaves(lambda g: g * scale.to(g.dtype), grads), norm


def apply_update(cfg: OptConfig, params, grads, state) -> tuple[Any, dict, dict]:
    """Returns (new_params, new_state, metrics)."""
    metrics = {}
    if cfg.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        metrics["grad_norm"] = gnorm
    step = state["step"] + 1
    lr = cfg.lr
    new_state: dict[str, Any] = {"step": step}
    f32 = lambda x: x.float()

    if cfg.kind == "sgd":
        upd = map_leaves(lambda g: lr * f32(g), grads)
    elif cfg.kind == "momentum":
        m = map_leaves(lambda m, g: cfg.momentum * m + f32(g), state["m"], grads)
        # Nesterov
        upd = map_leaves(lambda m, g: lr * (cfg.momentum * m + f32(g)), m, grads)
        new_state["m"] = m
    elif cfg.kind == "rmsprop":
        v = map_leaves(lambda v, g: cfg.beta2 * v + (1 - cfg.beta2) * f32(g).square(),
                       state["v"], grads)
        upd = map_leaves(lambda v, g: lr * f32(g) / (torch.sqrt(v) + cfg.eps), v, grads)
        new_state["v"] = v
    elif cfg.chunked:  # adam/adamw, one layer slice at a time
        bc1 = 1 - cfg.beta1 ** step.float()
        bc2 = 1 - cfg.beta2 ** step.float()
        wd = cfg.weight_decay if cfg.kind == "adamw" else 0.0

        def one(p, g, m, v):
            g = g.float()
            m = cfg.beta1 * m + (1 - cfg.beta1) * g
            v = cfg.beta2 * v + (1 - cfg.beta2) * g.square()
            u = lr * (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if wd:
                u = u + lr * wd * p.float()
            return (p.float() - u).to(p.dtype), m, v

        def leaf_update(p, g, m, v):
            if p.dim() >= 2 and p.shape[0] > 1:
                outs = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
                for i in range(p.shape[0]):
                    for o, x in zip(outs, one(p[i], g[i], m[i], v[i])):
                        o[i] = x
                return outs
            return one(p, g, m, v)

        pairs = [list(tree_leaves(t)) for t in (params, grads, state["m"], state["v"])]
        paths = [p for p, _ in pairs[0]]
        out = [leaf_update(*(pr[i][1] for pr in pairs)) for i in range(len(paths))]
        new_state["m"] = tree_from_leaves(paths, [o[1] for o in out])
        new_state["v"] = tree_from_leaves(paths, [o[2] for o in out])
        return tree_from_leaves(paths, [o[0] for o in out]), new_state, metrics
    else:  # adam / adamw
        m = map_leaves(lambda m, g: cfg.beta1 * m + (1 - cfg.beta1) * f32(g),
                       state["m"], grads)
        v = map_leaves(lambda v, g: cfg.beta2 * v + (1 - cfg.beta2) * f32(g).square(),
                       state["v"], grads)
        bc1 = 1 - cfg.beta1 ** step.float()
        bc2 = 1 - cfg.beta2 ** step.float()
        upd = map_leaves(lambda m, v: lr * (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps),
                         m, v)
        new_state["m"], new_state["v"] = m, v

    if cfg.kind == "adamw" and cfg.weight_decay:
        upd = map_leaves(lambda u, p: u + lr * cfg.weight_decay * f32(p), upd, params)
    new_params = map_leaves(lambda p, u: (f32(p) - u).to(p.dtype), params, upd)
    return new_params, new_state, metrics
