"""Zamba2 hybrid assembly [arXiv:2411.15242]: a stack of Mamba2 layers with
a single *shared* transformer block (attention + MLP) applied every
``attn_every`` layers, taking concat(hidden, original embedding) as input
(Zamba's global skip), projected back to d_model.

The port of the reference's ``models/zamba.py``.  Parameters
keep the reference's tree (Mamba2 layers stacked on axis 0), so a
converted JAX tree loads unchanged.  As in ``lm.py``, compute-dtype weight
copies are made once (:func:`cast_for_compute`) and caches are updated in
place.  ``cfg.attn_impl`` picks the path: ``"kernel"`` runs the flash
forward in the shared block's prefill attention, the SSD scan kernel in
every Mamba2 prefill and the RMSNorm kernels for every norm; ``"chunked"``
runs the plain PyTorch versions.

Training (:func:`loss_fn`) reads the fp32 master parameters through the
same per-use casts and remats each Mamba2 block (the shared block is not
rematted, as in the reference).  Every kernel on the path is
differentiable: flash, the SSD scan and the norms each recompute their
backward through the plain version.

Simplifications vs the released checkpoints (as in the reference): the
per-invocation LoRA deltas on the shared block are omitted; the shared
block's attention operates at d_model (after the concat projection).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from .attention import apply_rope, chunked_attention, decode_attention, rope_tables
from .common import (
    ParamSpec,
    cast_tree,
    cross_entropy_loss,
    decode_positions,
    dtype_of,
    init_tree,
    norm,
    norm_add,
    remat_wrap,
    use,
    use_layer,
)
from .lm import ATTN_IMPLS
from .ssm import (
    FP32_PARAMS,
    mamba_block_decode,
    mamba_block_fwd,
    mamba_block_specs,
    mamba_state_specs,
)

# serve-engine state kind: each lane carries BOTH a slotted KV segment
# (the shared attention block, seq axis, lazily overwritten) and per-lane
# recurrent mamba leaves (no seq axis, hard-reset) — the engine composes
# the two through one cache dict
STATE_KIND = "hybrid"
NORM_PARAMS = FP32_PARAMS | {"ln1", "ln2", "ln_f"}


def check_supported(cfg: ArchConfig) -> None:
    if cfg.family != "hybrid":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not "
                                  "the hybrid family")
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {cfg.attn_impl!r} not in {ATTN_IMPLS}")


def _segments(cfg: ArchConfig) -> list[int]:
    """Layer counts between shared-block invocations."""
    k = cfg.attn_every
    segs, rem = [], cfg.n_layers
    while rem > 0:
        segs.append(min(k, rem))
        rem -= k
    return segs


def n_shared_invocations(cfg: ArchConfig) -> int:
    return len(_segments(cfg))


def param_specs(cfg: ArchConfig) -> dict:
    check_supported(cfg)
    D, dh, H, Hk = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv
    dt = dtype_of(cfg.param_dtype)
    shared = {
        "proj_in": ParamSpec((2 * D, D), ("fsdp", None), dt),
        "ln1": ParamSpec((D,), (None,), dt, init_scale=0.0),
        "wq": ParamSpec((D, H * dh), ("fsdp", "tp"), dt),
        "wk": ParamSpec((D, Hk * dh), ("fsdp", "tp"), dt),
        "wv": ParamSpec((D, Hk * dh), ("fsdp", "tp"), dt),
        "wo": ParamSpec((H * dh, D), ("tp", "fsdp"), dt),
        "ln2": ParamSpec((D,), (None,), dt, init_scale=0.0),
        "wg": ParamSpec((D, cfg.d_ff), ("fsdp", "tp"), dt),
        "wu": ParamSpec((D, cfg.d_ff), ("fsdp", "tp"), dt),
        "wd": ParamSpec((cfg.d_ff, D), ("tp", "fsdp"), dt),
    }
    return {
        "embed": ParamSpec((cfg.vocab, D), ("tp", "fsdp"), dt),
        "ln_f": ParamSpec((D,), (None,), dt, init_scale=0.0),
        "unembed": ParamSpec((D, cfg.vocab), ("fsdp", "tp"), dt),
        "mamba": mamba_block_specs(cfg, cfg.n_layers),
        "shared": shared,
    }


def init(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Parameters from a seeded ``torch.Generator`` on ``device`` (the
    reference's shapes and scales, not its random bits)."""
    return init_tree(seed, param_specs(cfg), device)


def cast_for_compute(cfg: ArchConfig, params: dict, device=None) -> dict:
    """The tree the serving path reads: matmul, conv and embedding weights
    in the compute dtype (made once here); norm scales and the fp32-read
    leaves (``dt_bias``, ``A_log``, ``D_skip``) as stored."""
    check_supported(cfg)
    return cast_tree(params, dtype_of(cfg.compute_dtype), NORM_PARAMS, device)


# ---------------------------------------------------------------------------


def _w(p, name, cfg):
    return p[name].to(dtype_of(cfg.compute_dtype))


def _mlp(cfg, h, sp):
    g = h @ _w(sp, "wg", cfg)
    u = h @ _w(sp, "wu", cfg)
    return (F.silu(g) * u) @ _w(sp, "wd", cfg)


def _prefill_rope(cfg, B, S, device):
    positions = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def _shared_fwd(cfg, x, x0, sp, rope_cs=None):
    """Shared transformer block, prefill.  x/x0: (B,S,D).  Returns
    (x', (k, v)) with k after RoPE.  ``rope_cs``: the positions'
    ``rope_tables``, which a forward computes once for every invocation
    (made here when left None)."""
    B, S, _ = x.shape
    dh, H, Hk = cfg.head_dim, cfg.n_heads, cfg.n_kv
    # each invocation gathers; not rematted, so its products keep the
    # shards for the backward, which gathers again (common._pack)
    sp = use_layer(cfg, sp, ("shared",), lead=0)
    u = torch.cat([norm(cfg, x, sp["ln1"]), x0], dim=-1) @ _w(sp, "proj_in", cfg)
    if rope_cs is None:
        rope_cs = _prefill_rope(cfg, B, S, x.device)
    q = (u @ _w(sp, "wq", cfg)).reshape(B, S, H, dh)
    k = (u @ _w(sp, "wk", cfg)).reshape(B, S, Hk, dh)
    v = (u @ _w(sp, "wv", cfg)).reshape(B, S, Hk, dh)
    q = apply_rope(q, *rope_cs)
    kr = apply_rope(k, *rope_cs)
    if cfg.attn_impl == "kernel":
        from repro_torch.kernels.flash_attention.ops import flash_attention
        attn = flash_attention(q, kr, v, causal=True)
    else:
        attn = chunked_attention(q, kr, v, causal=True,
                                 q_chunk=min(256, S), kv_chunk=min(256, S))
    o = attn.reshape(B, S, -1) @ _w(sp, "wo", cfg)
    h, x = norm_add(cfg, x, o, sp["ln2"])
    return x + _mlp(cfg, h, sp), (kr, v)


def _decode_rope(cfg, cur_index, B, device):
    # scalar (aligned batch) or (B,) vector (slotted serve: per-lane
    # positions) — decode_attention handles both
    return rope_tables(decode_positions(cur_index, B, device), cfg.head_dim, cfg.rope_theta)


def _shared_decode(cfg, x, x0, sp, kc, vc, cur_index, rope_cs=None):
    """Shared block, one token per lane.  x/x0: (B,D); kc/vc (B,S,Hk,dh)
    are written in place at ``cur_index``.  ``rope_cs`` as in
    :func:`_shared_fwd`, of the lanes' positions."""
    B = x.shape[0]
    dh, H, Hk = cfg.head_dim, cfg.n_heads, cfg.n_kv
    u = torch.cat([norm(cfg, x, sp["ln1"]), x0], dim=-1) @ _w(sp, "proj_in", cfg)
    q = (u @ _w(sp, "wq", cfg)).reshape(B, H, dh)
    k = (u @ _w(sp, "wk", cfg)).reshape(B, Hk, dh)
    v = (u @ _w(sp, "wv", cfg)).reshape(B, Hk, dh)
    if rope_cs is None:
        rope_cs = _decode_rope(cfg, cur_index, B, x.device)
    q = apply_rope(q[:, None], *rope_cs)[:, 0].reshape(B, Hk, H // Hk, dh)
    k = apply_rope(k[:, None], *rope_cs)[:, 0]
    attn = decode_attention(q, kc, vc, k, v, cur_index)
    o = attn.reshape(B, H * dh) @ _w(sp, "wo", cfg)
    h, x = norm_add(cfg, x, o, sp["ln2"])
    return x + _mlp(cfg, h, sp)


def _embed(cfg, params, tokens):
    return F.embedding(tokens.long(), use(cfg, params, "embed"))


def _unembed(cfg, params, x):
    return x @ use(cfg, params, "unembed")


def _layer(params, i):
    return {name: p[i] for name, p in params["mamba"].items()}


def forward(cfg, params, tokens, *, remat=True, collect: bool = False,
            plen: int | None = None):
    """Returns (hidden, cache dict or None): with ``collect=True`` the
    second element is ``{"k", "v", "ssm", "conv"}`` — the shared block's
    stacked KV plus the mamba final states — else ``None``.

    ``remat`` (False | True | "dots", see ``common.remat_wrap``) wraps each
    Mamba2 block of the training path (``collect=False``), as the
    reference wraps its per-segment scan body; the shared block is not
    rematted.

    ``plen`` (slot-serving prefill only): positions beyond it are
    right-padding of a length bucket.  The attention KV of padded
    positions is inert by causality; the *mamba* states snapshot position
    ``plen`` exactly (``dt = 0`` identity steps + conv state sliced at
    plen, see ssm.py).
    """
    check_supported(cfg)
    x = _embed(cfg, params, tokens)
    valid = None
    if plen is not None:
        valid = (torch.arange(tokens.shape[1], device=x.device) < plen)[None, :]
        x = torch.where(valid[..., None], x, 0.0)     # pad activations stay finite
    x0 = x
    rope_cs = _prefill_rope(cfg, *tokens.shape, x.device)
    # the layer's shards are gathered inside the remat, so the recompute
    # gathers them again
    block = None if collect else remat_wrap(
        lambda x, bp: mamba_block_fwd(cfg, x, use_layer(cfg, bp, ("mamba",))), remat)
    kvs, ssm, conv = [], [], []
    off = 0
    for n in _segments(cfg):
        x, kv = _shared_fwd(cfg, x, x0, params["shared"], rope_cs)
        kvs.append(kv)
        for i in range(off, off + n):
            if collect:
                x, (s, c) = mamba_block_fwd(cfg, x, _layer(params, i), return_state=True,
                                            valid=valid, state_len=plen)
                ssm.append(s)
                conv.append(c)
            else:
                x = block(x, _layer(params, i))
        off += n
    x = norm(cfg, x, params["ln_f"])
    if not collect:
        return x, None
    return x, {"k": torch.stack([kv[0] for kv in kvs]),
               "v": torch.stack([kv[1] for kv in kvs]),
               "ssm": torch.stack(ssm), "conv": torch.stack(conv)}


def loss_fn(cfg: ArchConfig, params, batch, *, remat=True):
    """Next-token loss on ``batch["tokens"]`` (B, S + 1).  Returns
    ``(loss, {"ce_loss", "lb_loss", "drop_frac"})`` (the last two 0), as the
    reference's."""
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    hidden, _ = forward(cfg, params, inp, remat=remat)
    loss = cross_entropy_loss(_unembed(cfg, params, hidden), labels)
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss, {"ce_loss": loss, "lb_loss": zero, "drop_frac": zero}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def recurrent_leaf_axes(cfg: ArchConfig) -> dict:
    """The mamba leaves are per-lane recurrent state (lane axis 1); ``k``
    and ``v`` stay on the KV lifecycle (lazy overwrite)."""
    return {"ssm": 1, "conv": 1}


def lane_leaf_axes(cfg: ArchConfig) -> dict:
    """All slot-cache leaves a lane owns: the slotted KV segment (lane axis
    1, after the shared-invocation axis) plus the recurrent mamba leaves."""
    return {"k": 1, "v": 1, **recurrent_leaf_axes(cfg)}


def make_cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """The composed hybrid cache as meta tensors: k/v (n_shared, batch,
    max_len, Hk, dh) in the compute dtype, ssm (L, batch, H, N, P) fp32,
    conv (L, batch, K-1, conv channels) in the compute dtype."""
    kv = torch.empty((n_shared_invocations(cfg), batch, max_len, cfg.n_kv, cfg.head_dim),
                     dtype=dtype_of(cfg.compute_dtype), device="meta")
    return {"k": kv, "v": kv, **mamba_state_specs(cfg, cfg.n_layers, batch)}


def prefill(cfg, params, tokens, *, max_len: int | None = None):
    """tokens (B, S) -> (cache with k/v padded to ``max_len``, logits (B, V)
    at the last position)."""
    hidden, cache = forward(cfg, params, tokens, collect=True)
    S = tokens.shape[1]
    if max_len and max_len > S:
        for name in ("k", "v"):
            cache[name] = F.pad(cache[name], [0, 0, 0, 0, 0, max_len - S])
    return cache, _unembed(cfg, params, hidden[:, -1])


def decode_step(cfg, params, cache, tokens, cur_index):
    """tokens: (B,) int32; cur_index: tokens already in the cache, a scalar
    or a (B,) vector.  Returns (logits (B, V), cache), the cache updated in
    place."""
    check_supported(cfg)
    x = _embed(cfg, params, tokens)
    x0 = x
    rope_cs = _decode_rope(cfg, cur_index, x.shape[0], x.device)
    off = 0
    for si, n in enumerate(_segments(cfg)):
        x = _shared_decode(cfg, x, x0, params["shared"], cache["k"][si],
                           cache["v"][si], cur_index, rope_cs)
        for i in range(off, off + n):
            x, s, c = mamba_block_decode(cfg, x, _layer(params, i), cache["ssm"][i],
                                         cache["conv"][i])
            cache["ssm"][i] = s
            cache["conv"][i] = c
        off += n
    x = norm(cfg, x, params["ln_f"])
    return _unembed(cfg, params, x), cache


def prefill_slot(cfg, params, cache, tokens, slot: int, plen: int):
    """Prefill ONE prompt into lane ``slot`` of the composed hybrid cache.

    tokens: (1, S_bucket) right-padded.  The lane write covers both state
    kinds at once: the shared block's K/V land in the lane's seq slice
    ``[0, S_bucket)`` (padded tail inert by causality + lazy overwrite)
    and the mamba ``ssm``/``conv`` leaves land as the lane's recurrent
    snapshot at position ``plen`` (dt = 0 identity padding, see ssm.py).
    Returns (cache, logits (1, V) at position plen - 1); cache in place.
    """
    hidden, col = forward(cfg, params, tokens, collect=True, plen=plen)
    S = tokens.shape[1]
    cache["k"][:, slot, :S] = col["k"][:, 0].to(cache["k"].dtype)
    cache["v"][:, slot, :S] = col["v"][:, 0].to(cache["v"].dtype)
    cache["ssm"][:, slot] = col["ssm"][:, 0]
    cache["conv"][:, slot] = col["conv"][:, 0].to(cache["conv"].dtype)
    return cache, _unembed(cfg, params, hidden[:, plen - 1])
