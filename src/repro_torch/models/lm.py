"""Decoder-only LM, dense family (llama-arch: smollm, stablelm, deepseek;
gemma2's alternating local/global layers) and the qwen3 MoE family.

The port of the reference's ``models/lm.py`` for serving and training.
Parameters are nested dicts of tensors with the reference's tree: layers
stacked on the leading axes, ``(L,)``, or ``(L/2, 2)`` for gemma2, whose
pairs are (local, global); a layer's weights are views
``blocks[name][idx]`` (:func:`_lead_index`), so the layer loop never
copies.  Every walk visits the layers in order, layer ``i`` with its
window (:func:`_window`: under gemma2 ``cfg.window`` for even ``i``, full
causal for odd).

gemma2 (``alt_local_global``): embeddings scaled by ``sqrt(d_model)``
rounded to the compute dtype first (as the reference's
``jnp.asarray(np.sqrt(D), cdt)``), post-norms ``ln1b`` on the attention
output and ``ln2b`` on the FFN output, each before its residual add.

Weight casts: the reference casts every fp32 weight to the compute dtype
at each use, which XLA fuses; eager PyTorch would copy the whole model
every serving step.  :func:`cast_for_compute` makes the compute-dtype
copies once (norm scales stay fp32, as the reference reads them), and
every use below is then a no-op ``.to`` — the same numbers.  Training
(:func:`loss_fn`) reads the fp32 master parameters through the same
per-use cast ``_w``, so the cast is part of the graph and gradients land
in fp32.

Caches are updated IN PLACE: each layer attends through a view of its
slice of the stacked cache ``(lead..., ...)``, where the reference
carries the cache through a ``fori_loop`` with dynamic updates.
Functions that mutate a cache also return it, mirroring the reference's
signatures.

Norms: under ``cfg.attn_impl == "kernel"`` each RMSNorm is one launch of
the RMSNorm kernels (``common.norm``), and the residual add before ``ln2``
is folded into ``rmsnorm_add`` (``common.norm_add``), which normalises the
unrounded fp32 sum: in bf16 one rounding apart from the plain path, which
rounds ``x + o`` first; the residual stream itself is bitwise the same.
gemma2's post-norms are one ``norm`` launch each: ``ln2`` stays
``norm_add`` over ``x + ln1b(o)``.

MoE (``cfg.moe.num_experts``): each block's FFN is ``moe.moe_ffn`` over
the block's ``router``, ``wg_e``, ``wu_e`` and ``wd_e`` on every path that
runs an FFN (prefill, a chunked-prefill continuation, decode); the router
stays in its stored dtype, as the reference reads it in fp32.  Each call
routes every row it is given: a bucket's padding, a chunk's own length,
all of a decode step's lanes.  Training it (``loss_fn``, with the
reference's ``lb_loss`` term) arrives with the MoE training slice; VLM
raises ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from .attention import (
    chunked_attention,
    decode_attention,
    paged_decode_attention,
    apply_rope,
    paged_gather,
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
from .moe import moe_ffn

STATE_KIND = "kv"
ATTN_IMPLS = ("chunked", "kernel")
NORM_PARAMS = frozenset({"ln1", "ln2", "ln1b", "ln2b", "ln_f", "qnorm", "knorm"})
# leaves the serving path reads in their stored dtype: the norm scales and
# the MoE router (the reference computes router logits in fp32)
STORED_DTYPE = NORM_PARAMS | {"router"}


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the parts of the lm families this slice does not port."""
    if cfg.family == "vlm":
        raise NotImplementedError(
            f"{cfg.name}: the vlm family arrives with the VLM/audio slice of the port")
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not "
                                  "an lm family")
    if (cfg.family == "moe") != bool(cfg.moe.num_experts):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} with "
                         f"{cfg.moe.num_experts} experts")
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {cfg.attn_impl!r} not in {ATTN_IMPLS}")


# ---------------------------------------------------------------------------
# Parameter declaration
# ---------------------------------------------------------------------------


def _leading(cfg: ArchConfig) -> tuple[int, ...]:
    """The layer axes every block parameter and cache leaf leads with:
    ``(L,)``, or ``(L/2, 2)`` (local, global) pairs under gemma2."""
    if cfg.alt_local_global:
        if cfg.n_layers % 2:
            raise ValueError(f"{cfg.name}: alternating layers need an even "
                             f"layer count, got {cfg.n_layers}")
        return (cfg.n_layers // 2, 2)
    return (cfg.n_layers,)


def _lead_index(cfg: ArchConfig, i: int) -> tuple[int, ...]:
    """Layer ``i``'s index into the leading axes."""
    return divmod(i, 2) if cfg.alt_local_global else (i,)


def _window(cfg: ArchConfig, i: int) -> int:
    """Layer ``i``'s attention window (0: full causal); a gemma2 pair is
    (local, global)."""
    if cfg.alt_local_global:
        return (cfg.window, 0)[i % 2]
    return cfg.window


def block_specs(cfg: ArchConfig) -> dict:
    L = _leading(cfg)
    D, dh, H, Hk, F_ = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv, cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    s = {
        "ln1": ParamSpec(L + (D,), dt, init_scale=0.0),
        "ln2": ParamSpec(L + (D,), dt, init_scale=0.0),
        "wq": ParamSpec(L + (D, H * dh), dt),
        "wk": ParamSpec(L + (D, Hk * dh), dt),
        "wv": ParamSpec(L + (D, Hk * dh), dt),
        "wo": ParamSpec(L + (H * dh, D), dt),
    }
    if cfg.moe.num_experts:
        E, Fe = cfg.moe.num_experts, cfg.moe.d_expert
        s["router"] = ParamSpec(L + (D, E), dt)
        s["wg_e"] = ParamSpec(L + (E, D, Fe), dt)
        s["wu_e"] = ParamSpec(L + (E, D, Fe), dt)
        s["wd_e"] = ParamSpec(L + (E, Fe, D), dt)
    else:
        s["wg"] = ParamSpec(L + (D, F_), dt)
        s["wu"] = ParamSpec(L + (D, F_), dt)
        s["wd"] = ParamSpec(L + (F_, D), dt)
    if cfg.qk_norm:
        s["qnorm"] = ParamSpec(L + (dh,), dt, init_scale=0.0)
        s["knorm"] = ParamSpec(L + (dh,), dt, init_scale=0.0)
    if cfg.alt_local_global:                 # gemma2 post-norms
        s["ln1b"] = ParamSpec(L + (D,), dt, init_scale=0.0)
        s["ln2b"] = ParamSpec(L + (D,), dt, init_scale=0.0)
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
    the compute dtype (made once here), norm scales and the MoE router as
    stored."""
    check_supported(cfg)
    return cast_tree(params, dtype_of(cfg.compute_dtype), STORED_DTYPE, device)


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


def _ffn(cfg, x, bp, aux_sink=None):
    """The block's FFN: SwiGLU/GeGLU, or under MoE ``moe_ffn`` over every
    row of ``x``; its aux dict is appended to ``aux_sink`` where one is
    given."""
    if cfg.moe.num_experts:
        out, aux = moe_ffn(x, bp["router"], bp["wg_e"], bp["wu_e"], bp["wd_e"], cfg=cfg)
        if aux_sink is not None:
            aux_sink.append(aux)
        return out
    g = x @ _w(bp, "wg", cfg)
    u = x @ _w(bp, "wu", cfg)
    return (_gate(cfg, g) * u) @ _w(bp, "wd", cfg)


def _block_fwd(cfg, x, bp, rope_cs, *, window: int, attn_fn=None, aux_sink=None):
    """One transformer block, prefill path.  Returns (x, (k, v)).
    ``attn_fn(q, k, v, window)`` replaces the attention (a chunked-prefill
    continuation's, :func:`_block_chunk`); everything around it is
    shared."""
    h = norm(cfg, x, bp["ln1"])
    q, k, v = _attn_proj(cfg, h, bp, rope_cs)
    if attn_fn is not None:
        attn = attn_fn(q, k, v, window)
    elif cfg.attn_impl == "kernel":
        from repro_torch.kernels.flash_attention.ops import flash_attention
        attn = flash_attention(q, k, v, causal=True, window=window,
                               softcap=cfg.attn_softcap)
    else:
        attn = chunked_attention(
            q, k, v, causal=True, window=window, softcap=cfg.attn_softcap,
            q_chunk=min(256, q.shape[1]), kv_chunk=min(256, k.shape[1]))
    B, S = x.shape[:2]
    h, x = _attn_out(cfg, x, attn.reshape(B, S, -1) @ _w(bp, "wo", cfg), bp)
    return _ffn_out(cfg, x, _ffn(cfg, h, bp, aux_sink), bp), (k, v)


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
    h, x = _attn_out(cfg, x, attn.reshape(B, H * dh) @ _w(bp, "wo", cfg), bp)
    return _ffn_out(cfg, x, _ffn(cfg, h, bp), bp)


def _attn_out(cfg, x, o, bp):
    """The residual add of the attention output ``o`` (after gemma2's
    ``ln1b``) and ``ln2`` of the sum: returns ``(ln2(x'), x')``."""
    if cfg.alt_local_global:
        o = norm(cfg, o, bp["ln1b"])
    return norm_add(cfg, x, o, bp["ln2"])


def _ffn_out(cfg, x, f, bp):
    """The residual add of the FFN output (after gemma2's ``ln2b``)."""
    if cfg.alt_local_global:
        f = norm(cfg, f, bp["ln2b"])
    return x + f


def _layer(cfg, params, i):
    idx = _lead_index(cfg, i)
    return {name: p[idx] for name, p in params["blocks"].items()}


def _cache_layer(cfg, cache, i):
    """Layer ``i``'s (k, v) views of a stacked cache."""
    idx = _lead_index(cfg, i)
    return cache["k"][idx], cache["v"][idx]


def _stack_layers(cfg, ts):
    """Per-layer tensors stacked on the leading axes."""
    t = torch.stack(ts)
    return t.view(_leading(cfg) + t.shape[1:])


def _flat_layers(cfg, t):
    """A stacked leaf with its leading axes as one layer axis: a view, so a
    write through it lands in the leaf (a non-contiguous leaf raises)."""
    return t.view((-1,) + t.shape[len(_leading(cfg)):])


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------


def embed_tokens(cfg, params, tokens):
    cdt = dtype_of(cfg.compute_dtype)
    x = F.embedding(tokens.long(), params["embed"].to(cdt))
    if cfg.alt_local_global:
        # gemma scales embeddings, the scale rounded to cdt first (a Python
        # float: no host-to-device copy, so a decode graph can capture it;
        # the product is taken in fp32 and rounded, as a cdt x cdt one is)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt).item()
    return x


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
            collect_kv: bool = False, aux: dict | None = None):
    """tokens (B, S) -> (final-normed hidden (B, S, D), kv or None) with kv
    = (k, v) stacked over layers: (lead..., B, S, Hk, dh) each.  ``remat``
    (False | True | "dots", see ``common.remat_wrap``) wraps each block.
    ``aux``, where given, receives the reference forward's aux: the MoE
    layers' ``lb_loss`` summed and ``drop_frac`` maxed over layers (0 for
    dense models), and each MoE layer's ``drop_frac`` in order
    (``drop_frac_layers``, (L,) or empty)."""
    check_supported(cfg)
    sink = [] if aux is not None else None
    x = embed_tokens(cfg, params, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    def body(x, bp, window):
        return _block_fwd(cfg, x, bp, rope_cs, window=window, aux_sink=sink)

    body = remat_wrap(body, remat)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = body(x, _layer(cfg, params, i), _window(cfg, i))
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = norm(cfg, x, params["ln_f"])
    if aux is not None:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux["lb_loss"] = sum((a["lb_loss"] for a in sink), zero)
        layers = torch.stack([zero] + [a["drop_frac"] for a in sink])
        aux["drop_frac"] = layers.amax()
        aux["drop_frac_layers"] = layers[1:]
    return x, ((_stack_layers(cfg, ks), _stack_layers(cfg, vs)) if collect_kv else None)


def loss_fn(cfg: ArchConfig, params, batch, *, remat=True):
    """Next-token loss on ``batch["tokens"]`` (B, S + 1).  Returns
    ``(total, {"ce_loss", "lb_loss", "drop_frac"})``; the load-balance
    loss and drop fraction are 0 for dense models, so total == ce_loss.
    MoE training (the reference adds its ``lb_loss`` term) is not ported
    yet."""
    if cfg.moe.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: training the moe family (with its load-balance "
            "loss) arrives with the MoE training slice of the port")
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
    """Slotted KV cache (lead..., B, S, Hk, dh) as meta tensors (shape +
    dtype)."""
    shape = _leading(cfg) + (batch, max_len, cfg.n_kv, cfg.head_dim)
    c = torch.empty(shape, dtype=dtype_of(cfg.compute_dtype), device="meta")
    return {"k": c, "v": c}


def lane_leaf_axes(cfg: ArchConfig) -> dict:
    """``{cache leaf: lane axis}`` of the slotted cache: everything one lane
    owns, the host tier's unit of a whole-lane spill.  Both leaves put the
    lane right after the leading layer axes."""
    lead = len(_leading(cfg))
    return {"k": lead, "v": lead}


def make_paged_cache_specs(cfg: ArchConfig, num_blocks: int, block_size: int) -> dict:
    """Paged KV pool (lead..., NB, bs, Hk, dh) as meta tensors."""
    shape = _leading(cfg) + (num_blocks, block_size, cfg.n_kv, cfg.head_dim)
    c = torch.empty(shape, dtype=dtype_of(cfg.compute_dtype), device="meta")
    return {"k": c, "v": c}


def copy_paged_block(cfg: ArchConfig, cache, src: int, dst: int):
    """Copy physical pool block ``src`` to ``dst`` in every cache leaf, in
    place: the prefix cache's copy-on-write step (a new request's prompt
    covers a shared block whole but must rewrite its tail position, since
    the sampling position is always recomputed; the lane gets the private
    copy).  Leaves are (lead..., NB, bs, Hk, dh); the block axis is
    ``ndim - 4``.
    One indexed copy per leaf, on the current stream, so it is ordered
    before the continuation chunk that overwrites the copy's tail."""
    for c in cache.values():
        axis = c.dim() - 4
        c.select(axis, dst).copy_(c.select(axis, src))
    return cache


def prefill(cfg: ArchConfig, params, tokens, *, max_len: int | None = None):
    """Whole-batch prefill: tokens (B, S) -> (slotted cache {k, v} of
    (lead..., B, max_len, Hk, dh), the KV of positions [0, S) and zeros past it;
    logits (B, V) at the last position)."""
    hidden, (k, v) = forward(cfg, params, tokens, remat=False, collect_kv=True)
    S = tokens.shape[1]
    pad = [0, 0, 0, 0, 0, max(0, (max_len or S) - S)]
    cache = {"k": F.pad(k, pad), "v": F.pad(v, pad)}
    return cache, unembed(cfg, params, hidden[:, -1])


def prefill_slot(cfg: ArchConfig, params, cache, tokens, slot: int, plen: int):
    """Prefill ONE prompt into lane ``slot`` of the slotted cache.

    tokens: (1, S_bucket) — the prompt right-padded to its bucket; the
    whole padded bucket is written into the lane (causality makes the
    padding inert, and decode overwrites the tail before reading it).
    Returns (cache, logits (1, V) at position plen-1); cache in place.
    """
    hidden, (k, v) = forward(cfg, params, tokens, remat=False, collect_kv=True)
    S = tokens.shape[1]
    for name, new in (("k", k), ("v", v)):
        cache[name][..., slot, :S, :, :] = new.select(-4, 0).to(cache[name].dtype)
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
        paged_write_positions(_flat_layers(cfg, cache[name]), table_row, pos,
                              _flat_layers(cfg, new).select(1, 0), valid)
    last = min(max(plen - 1, 0), C - 1)
    return cache, unembed(cfg, params, hidden[:, last])


def _block_chunk(cfg, x, bp, kp, vp, table_row, start: int, plen: int, rope_cs, *,
                 window: int):
    """One transformer block of a chunked-prefill continuation.

    x: (1, C, D) hidden of prompt positions [start, start+C); kp/vp: this
    layer's pools (NB, bs, Hk, dh), written in place.  Rides
    :func:`_block_fwd` with an attention override: write the chunk's K/V
    through the table (positions ``>= plen`` to the sink), gather the
    lane, and attend the chunk's queries against it with
    ``chunked_attention(q_offset=start)`` (the lane's stale tail past
    ``start+C`` is causally masked; pad rows never feed valid rows).
    Returns x."""
    C = x.shape[1]
    pos = start + torch.arange(C, device=x.device)
    valid = pos < plen

    def attn_fn(q, k, v, w):
        paged_write_positions(kp, table_row, pos, k[0], valid)
        paged_write_positions(vp, table_row, pos, v[0], valid)
        kl = paged_gather(kp, table_row[None])         # (1, nb*bs, Hk, dh)
        vl = paged_gather(vp, table_row[None])
        return chunked_attention(q, kl, vl, causal=True, window=w,
                                 softcap=cfg.attn_softcap, q_chunk=min(256, C),
                                 kv_chunk=min(256, kl.shape[1]), q_offset=start)

    x, _ = _block_fwd(cfg, x, bp, rope_cs, window=window, attn_fn=attn_fn)
    return x


def prefill_chunk_paged(cfg: ArchConfig, params, cache, tokens, table_row,
                        start: int, plen: int):
    """Continue a chunked prefill: prompt positions [start, start+C)
    against the lane's paged KV (``start > 0``; the first chunk goes
    through :func:`prefill_slot_paged`).  tokens: (1, C), right-padded on
    the last chunk.  Every norm goes through ``common.norm``/``norm_add``
    (one RMSNorm kernel launch each on the kernel path); the attention is
    ``chunked_attention`` on both paths (the flash kernel has no query
    offset).  Returns (cache, logits (1, V) at prompt position
    ``min(plen, start+C) - 1``), the cache in place."""
    check_supported(cfg)
    x = embed_tokens(cfg, params, tokens)
    C = tokens.shape[1]
    pos = start + torch.arange(C, dtype=torch.int32, device=x.device)
    rope_cs = rope_tables(pos[None], cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = _block_chunk(cfg, x, _layer(cfg, params, i), *_cache_layer(cfg, cache, i),
                         table_row, start, plen, rope_cs, window=_window(cfg, i))
    x = norm(cfg, x, params["ln_f"])
    last = min(max(plen - 1 - start, 0), C - 1)
    return cache, unembed(cfg, params, x[:, last])


def _decode_walk(cfg, params, cache, x, cur_index, attn_fn):
    """Per-layer decode walk shared by the slotted and paged layouts; each
    layer reads and writes its slice ``cache[..][i]`` (a view) in place."""
    check_supported(cfg)
    pos = decode_positions(cur_index, x.shape[0], x.device)
    rope_cs = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = _block_decode(cfg, x, _layer(cfg, params, i), *_cache_layer(cfg, cache, i),
                          cur_index, rope_cs, window=_window(cfg, i), attn_fn=attn_fn)
    x = norm(cfg, x, params["ln_f"])
    return unembed(cfg, params, x), cache


def decode_step(cfg: ArchConfig, params, cache, tokens, cur_index):
    """tokens: (B,) int32; cur_index: tokens already in the cache, a
    scalar or a (B,) vector.  Returns (logits (B, V), cache)."""
    x = embed_tokens(cfg, params, tokens)
    return _decode_walk(cfg, params, cache, x, cur_index, None)


def decode_step_paged(cfg: ArchConfig, params, cache, tokens, lengths, tables,
                      *, impl: str = "ref"):
    """Paged decode: cache leaves are pools (lead..., NB, bs, Hk, dh); ``tables``
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
