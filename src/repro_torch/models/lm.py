"""Decoder-only LM, dense family (llama-arch: smollm, stablelm, deepseek).

The port of the reference's ``models/lm.py`` for serving and training.
Parameters are nested dicts of tensors with the reference's tree (layers
stacked on axis 0); a layer's weights are views ``blocks[name][i]``, so
the layer loop never copies.

Weight casts: the reference casts every fp32 weight to the compute dtype
at each use, which XLA fuses; eager PyTorch would copy the whole model
every serving step.  :func:`cast_for_compute` makes the compute-dtype
copies once (norm scales stay fp32, as the reference reads them), and
every use below is then a no-op ``.to`` — the same numbers.  Training
(:func:`loss_fn`) reads the fp32 master parameters through the same
per-use cast ``_w``, so the cast is part of the graph and gradients land
in fp32.

Caches are updated IN PLACE: each layer attends through a view of its
slice of the stacked cache ``(L, ...)``, where the reference carries the
cache through a ``fori_loop`` with dynamic updates.  Functions that
mutate a cache also return it, mirroring the reference's signatures.

Norms: under ``cfg.attn_impl == "kernel"`` each RMSNorm is one launch of
the RMSNorm kernels (``common.norm``), and the residual add before ``ln2``
is folded into ``rmsnorm_add`` (``common.norm_add``), which normalises the
unrounded fp32 sum: in bf16 one rounding apart from the plain path, which
rounds ``x + o`` first; the residual stream itself is bitwise the same.

MoE, VLM and gemma2's alternating local/global layers raise
``NotImplementedError``: they arrive with later slices of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from .attention import (
    chunked_attention,
    decode_attention,
    paged_decode_attention,
    apply_rope,
    paged_write_positions,
    rope_tables,
)
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
    softcap,
)

STATE_KIND = "kv"
ATTN_IMPLS = ("chunked", "kernel")
NORM_PARAMS = frozenset({"ln1", "ln2", "ln_f", "qnorm", "knorm"})


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the parts of the lm families this slice does not port."""
    if cfg.family in ("moe", "vlm") or cfg.moe.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family arrives with the MoE/VLM/"
            "audio slice of the port")
    if cfg.alt_local_global:
        raise NotImplementedError(
            f"{cfg.name}: gemma2's alternating local/global layers arrive "
            "with the gemma2 slice of the port")
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not "
                                  "an lm family")
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {cfg.attn_impl!r} not in {ATTN_IMPLS}")


# ---------------------------------------------------------------------------
# Parameter declaration
# ---------------------------------------------------------------------------


def block_specs(cfg: ArchConfig) -> dict:
    L = (cfg.n_layers,)
    D, dh, H, Hk, F_ = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv, cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    s = {
        "ln1": ParamSpec(L + (D,), dt, init_scale=0.0),
        "ln2": ParamSpec(L + (D,), dt, init_scale=0.0),
        "wq": ParamSpec(L + (D, H * dh), dt),
        "wk": ParamSpec(L + (D, Hk * dh), dt),
        "wv": ParamSpec(L + (D, Hk * dh), dt),
        "wo": ParamSpec(L + (H * dh, D), dt),
        "wg": ParamSpec(L + (D, F_), dt),
        "wu": ParamSpec(L + (D, F_), dt),
        "wd": ParamSpec(L + (F_, D), dt),
    }
    if cfg.qk_norm:
        s["qnorm"] = ParamSpec(L + (dh,), dt, init_scale=0.0)
        s["knorm"] = ParamSpec(L + (dh,), dt, init_scale=0.0)
    return s


def param_specs(cfg: ArchConfig) -> dict:
    check_supported(cfg)
    dt = dtype_of(cfg.param_dtype)
    D = cfg.d_model
    s = {
        "embed": ParamSpec((cfg.vocab, D), dt),
        "ln_f": ParamSpec((D,), dt, init_scale=0.0),
        "blocks": block_specs(cfg),
    }
    if not cfg.tie_embeddings:
        s["unembed"] = ParamSpec((D, cfg.vocab), dt)
    return s


def init(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Parameters from a seeded ``torch.Generator`` on ``device`` (the
    reference's shapes and scales, not its random bits)."""
    return init_tree(seed, param_specs(cfg), device)


def cast_for_compute(cfg: ArchConfig, params: dict, device=None) -> dict:
    """The tree the serving path reads: every matmul/embedding weight in
    the compute dtype (made once here), norm scales as stored."""
    check_supported(cfg)
    return cast_tree(params, dtype_of(cfg.compute_dtype), NORM_PARAMS, device)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _gate(cfg: ArchConfig, g):
    return F.gelu(g, approximate="tanh") if cfg.gate_act == "gelu" else F.silu(g)


def _q_scale(cfg: ArchConfig) -> float:
    # attention applies dh**-0.5; fold any override into q
    if cfg.query_scale:
        return cfg.query_scale * (cfg.head_dim ** 0.5)
    return 1.0


def _w(bp, name, cfg):
    return bp[name].to(dtype_of(cfg.compute_dtype))


def _attn_proj(cfg, h, bp, rope_cs):
    """q, k, v of one layer; ``rope_cs`` = ``rope_tables`` of the
    positions, computed once per forward."""
    B, S, _ = h.shape
    dh, H, Hk = cfg.head_dim, cfg.n_heads, cfg.n_kv
    q = (h @ _w(bp, "wq", cfg)).reshape(B, S, H, dh)
    k = (h @ _w(bp, "wk", cfg)).reshape(B, S, Hk, dh)
    v = (h @ _w(bp, "wv", cfg)).reshape(B, S, Hk, dh)
    if cfg.qk_norm:
        q = norm(cfg, q, bp["qnorm"])
        k = norm(cfg, k, bp["knorm"])
    q = apply_rope(q, *rope_cs)
    if _q_scale(cfg) != 1.0:
        q = q * _q_scale(cfg)
    k = apply_rope(k, *rope_cs)
    return q, k, v


def _ffn(cfg, x, bp):
    g = x @ _w(bp, "wg", cfg)
    u = x @ _w(bp, "wu", cfg)
    return (_gate(cfg, g) * u) @ _w(bp, "wd", cfg)


def _block_fwd(cfg, x, bp, rope_cs, *, window: int):
    """One transformer block, prefill path.  Returns (x, (k, v))."""
    h = norm(cfg, x, bp["ln1"])
    q, k, v = _attn_proj(cfg, h, bp, rope_cs)
    if cfg.attn_impl == "kernel":
        from repro_torch.kernels.flash_attention.ops import flash_attention
        attn = flash_attention(q, k, v, causal=True, window=window,
                               softcap=cfg.attn_softcap)
    else:
        attn = chunked_attention(
            q, k, v, causal=True, window=window, softcap=cfg.attn_softcap,
            q_chunk=min(256, q.shape[1]), kv_chunk=min(256, k.shape[1]))
    B, S = x.shape[:2]
    h, x = norm_add(cfg, x, attn.reshape(B, S, -1) @ _w(bp, "wo", cfg), bp["ln2"])
    return x + _ffn(cfg, h, bp), (k, v)


def _block_decode(cfg, x, bp, kc, vc, cur_index, rope_cs, *, window: int, attn_fn=None):
    """One block, single-token decode.  x: (B, D).  ``attn_fn(q, kc, vc,
    k_new, v_new, window)`` replaces the slotted cache write + attention
    (the paged path); everything around it is shared, so the layouts stay
    numerically identical.  ``rope_cs``: ``rope_tables`` of the lanes'
    positions (B, 1), computed once per step.  Returns x; kc/vc are
    written in place."""
    dh, H, Hk = cfg.head_dim, cfg.n_heads, cfg.n_kv
    B = x.shape[0]
    h = norm(cfg, x, bp["ln1"])
    q = (h @ _w(bp, "wq", cfg)).reshape(B, H, dh)
    k = (h @ _w(bp, "wk", cfg)).reshape(B, Hk, dh)
    v = (h @ _w(bp, "wv", cfg)).reshape(B, Hk, dh)
    if cfg.qk_norm:
        q = norm(cfg, q, bp["qnorm"])
        k = norm(cfg, k, bp["knorm"])
    q = apply_rope(q[:, None], *rope_cs)[:, 0]
    if _q_scale(cfg) != 1.0:
        q = q * _q_scale(cfg)
    k = apply_rope(k[:, None], *rope_cs)[:, 0]
    q = q.reshape(B, Hk, H // Hk, dh)
    if attn_fn is None:
        attn = decode_attention(q, kc, vc, k, v, cur_index, window=window,
                                softcap=cfg.attn_softcap)
    else:
        attn = attn_fn(q, kc, vc, k, v, window)
    h, x = norm_add(cfg, x, attn.reshape(B, H * dh) @ _w(bp, "wo", cfg), bp["ln2"])
    return x + _ffn(cfg, h, bp)


def _layer(params, i):
    return {name: p[i] for name, p in params["blocks"].items()}


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------


def embed_tokens(cfg, params, tokens):
    return F.embedding(tokens.long(), params["embed"].to(dtype_of(cfg.compute_dtype)))


def unembed(cfg, params, x):
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.tie_embeddings:
        w = params["embed"].to(cdt).t()
    else:
        w = params["unembed"].to(cdt)
    logits = x @ w
    if cfg.logit_softcap:
        logits = softcap(logits.float(), cfg.logit_softcap)
    return logits


def forward(cfg: ArchConfig, params, tokens, *, remat=True,
            collect_kv: bool = False):
    """tokens (B, S) -> (final-normed hidden (B, S, D), kv or None) with kv
    = (k, v) stacked over layers: (L, B, S, Hk, dh) each.  ``remat``
    (False | True | "dots", see ``common.remat_wrap``) wraps each block."""
    check_supported(cfg)
    x = embed_tokens(cfg, params, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    def body(x, bp):
        return _block_fwd(cfg, x, bp, rope_cs, window=cfg.window)

    body = remat_wrap(body, remat)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = body(x, _layer(params, i))
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = norm(cfg, x, params["ln_f"])
    return x, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)


def loss_fn(cfg: ArchConfig, params, batch, *, remat=True):
    """Next-token loss on ``batch["tokens"]`` (B, S + 1).  Returns
    ``(total, {"ce_loss", "lb_loss", "drop_frac"})``; the load-balance
    loss and drop fraction are 0 for dense models, so total == ce_loss."""
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    hidden, _ = forward(cfg, params, inp, remat=remat)
    loss = cross_entropy_loss(unembed(cfg, params, hidden), labels)
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss, {"ce_loss": loss, "lb_loss": zero, "drop_frac": zero}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def make_cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """Slotted KV cache (L, B, S, Hk, dh) as meta tensors (shape + dtype)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.head_dim)
    c = torch.empty(shape, dtype=dtype_of(cfg.compute_dtype), device="meta")
    return {"k": c, "v": c}


def make_paged_cache_specs(cfg: ArchConfig, num_blocks: int, block_size: int) -> dict:
    """Paged KV pool (L, NB, bs, Hk, dh) as meta tensors."""
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv, cfg.head_dim)
    c = torch.empty(shape, dtype=dtype_of(cfg.compute_dtype), device="meta")
    return {"k": c, "v": c}


def prefill_slot(cfg: ArchConfig, params, cache, tokens, slot: int, plen: int):
    """Prefill ONE prompt into lane ``slot`` of the slotted cache.

    tokens: (1, S_bucket) — the prompt right-padded to its bucket; the
    whole padded bucket is written into the lane (causality makes the
    padding inert, and decode overwrites the tail before reading it).
    Returns (cache, logits (1, V) at position plen-1); cache in place.
    """
    hidden, (k, v) = forward(cfg, params, tokens, remat=False, collect_kv=True)
    S = tokens.shape[1]
    cache["k"][:, slot, :S] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot, :S] = v[:, 0].to(cache["v"].dtype)
    last = min(max(plen - 1, 0), S - 1)
    return cache, unembed(cfg, params, hidden[:, last])


def prefill_slot_paged(cfg: ArchConfig, params, cache, tokens, table_row, plen: int):
    """Prefill positions [0, C) of one lane into the paged pool through its
    block table.  Same ``forward`` as :func:`prefill_slot` (so slotted and
    paged prefills are bitwise equal); positions ``>= plen`` go to the
    sink block 0.  Returns (cache, logits (1, V) at ``min(plen, C) - 1``)."""
    hidden, (k, v) = forward(cfg, params, tokens, remat=False, collect_kv=True)
    C = tokens.shape[1]
    pos = torch.arange(C, device=tokens.device)
    valid = pos < plen
    for name, new in (("k", k), ("v", v)):
        paged_write_positions(cache[name], table_row, pos, new[:, 0], valid)
    last = min(max(plen - 1, 0), C - 1)
    return cache, unembed(cfg, params, hidden[:, last])


def _decode_walk(cfg, params, cache, x, cur_index, attn_fn):
    """Per-layer decode walk shared by the slotted and paged layouts; each
    layer reads and writes its slice ``cache[..][i]`` (a view) in place."""
    check_supported(cfg)
    pos = decode_positions(cur_index, x.shape[0], x.device)
    rope_cs = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = _block_decode(cfg, x, _layer(params, i), cache["k"][i],
                          cache["v"][i], cur_index, rope_cs, window=cfg.window,
                          attn_fn=attn_fn)
    x = norm(cfg, x, params["ln_f"])
    return unembed(cfg, params, x), cache


def decode_step(cfg: ArchConfig, params, cache, tokens, cur_index):
    """tokens: (B,) int32; cur_index: tokens already in the cache, a
    scalar or a (B,) vector.  Returns (logits (B, V), cache)."""
    x = embed_tokens(cfg, params, tokens)
    return _decode_walk(cfg, params, cache, x, cur_index, None)


def decode_step_paged(cfg: ArchConfig, params, cache, tokens, lengths, tables,
                      *, impl: str = "ref"):
    """Paged decode: cache leaves are pools (L, NB, bs, Hk, dh); ``tables``
    (B, nb) maps lanes' logical blocks to pool blocks and ``lengths`` (B,)
    is both the RoPE position and the write position of the new token.
    ``impl``: "ref" (gather + masked softmax) or "kernel" (the
    block-walking CUDA kernel).  Returns (logits (B, V), cache)."""
    x = embed_tokens(cfg, params, tokens)

    def attn_fn(q, kc, vc, k_new, v_new, window):
        return paged_decode_attention(
            q, kc, vc, k_new, v_new, lengths, tables,
            window=window, softcap=cfg.attn_softcap, impl=impl)

    return _decode_walk(cfg, params, cache, x, lengths, attn_fn)
