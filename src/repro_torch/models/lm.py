"""Decoder-only LM, dense family (llama-arch: smollm, stablelm, deepseek;
gemma2's alternating local/global layers), the qwen3 MoE family and the
VLM family (InternVL2's backbone behind its stubbed vision frontend).

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
in fp32.  Under FSDP (the per-parameter train program) a block's sharded
weights are gathered in the compute dtype at the start of the rematted
block body (``common.use_layer``), so remat's recompute gathers them
again, and ``embed``/``unembed``/``img_proj`` at each use
(``common.use``), where a product that saves the gathered weight keeps
its shard instead and the backward gathers it again; outside that program
both return what they are given.

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
all of a decode step's lanes.  :func:`loss_fn` adds the reference's
load-balance term, ``1e-2 * lb_loss / n_layers``; the family trains on the
per-parameter path (``train.step.flat_engine_mode``), as the reference's.

VLM (``cfg.family == "vlm"``): the vision frontend is a stub, as in the
reference.  ``img_proj`` projects precomputed patch embeddings (B,
frontend_tokens, frontend_dim) to d_model (a plain product) and
:func:`forward` prepends them to the token embeddings; ``prefill`` takes
them as ``img_embeds``, and decoding continues at ``frontend_tokens +
S``.  The family serves on the static loop (``serve.loop.generate_static``),
not the slot engine, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from .attention import (
    DecodeSharding,
    chunked_attention,
    decode_attention,
    gather_lane,
    paged_decode_attention,
    apply_rope,
    paged_write_positions,
    rope_tables,
)
from .common import (
    COUNTS,
    ParamSpec,
    cast_tree,
    cross_entropy_loss,
    data_all_gather,
    decode_positions,
    dtype_of,
    init_tree,
    model_all_gather,
    model_axis,
    norm,
    norm_add,
    remat_wrap,
    serve_split,
    softcap,
    tp_enter,
    tp_exit,
    use,
    use_layer,
    vocab_parallel_cross_entropy,
)
from .moe import moe_ffn

STATE_KIND = "kv"
ATTN_IMPLS = ("chunked", "kernel")
NORM_PARAMS = frozenset({"ln1", "ln2", "ln1b", "ln2b", "ln_f", "qnorm", "knorm"})
# leaves the serving path reads in their stored dtype: the norm scales and
# the MoE router (the reference computes router logits in fp32)
STORED_DTYPE = NORM_PARAMS | {"router"}
# the families that run tensor, sequence and expert parallelism under a
# mesh program; serving (no sequence-sharded residual stream) also runs
# the vlm family's backbone, the patches prepended as text is
TP_FAMILIES = ("dense", "moe")
SERVE_TP_FAMILIES = TP_FAMILIES + ("vlm",)
# leaves replicated over the model axis but read inside the
# tensor-parallel region (the q/k norms on local or gathered heads, the
# router on the rank's experts): each model rank holds a partial sum of
# their gradient whatever the residual stream's layout
TP_REGION_LEAVES = frozenset({"qnorm", "knorm", "router"})


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a config the lm families do not serve."""
    if cfg.family not in ("dense", "moe", "vlm"):
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
    ll = (None,) * len(L)
    D, dh, H, Hk, F_ = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv, cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    s = {
        "ln1": ParamSpec(L + (D,), ll + (None,), dt, init_scale=0.0),
        "ln2": ParamSpec(L + (D,), ll + (None,), dt, init_scale=0.0),
        "wq": ParamSpec(L + (D, H * dh), ll + ("fsdp", "tp"), dt),
        "wk": ParamSpec(L + (D, Hk * dh), ll + ("fsdp", "tp"), dt),
        "wv": ParamSpec(L + (D, Hk * dh), ll + ("fsdp", "tp"), dt),
        "wo": ParamSpec(L + (H * dh, D), ll + ("tp", "fsdp"), dt),
    }
    if cfg.moe.num_experts:
        E, Fe = cfg.moe.num_experts, cfg.moe.d_expert
        s["router"] = ParamSpec(L + (D, E), ll + (None, None), dt)
        s["wg_e"] = ParamSpec(L + (E, D, Fe), ll + ("tp", "fsdp", None), dt)
        s["wu_e"] = ParamSpec(L + (E, D, Fe), ll + ("tp", "fsdp", None), dt)
        s["wd_e"] = ParamSpec(L + (E, Fe, D), ll + ("tp", None, "fsdp"), dt)
    else:
        s["wg"] = ParamSpec(L + (D, F_), ll + ("fsdp", "tp"), dt)
        s["wu"] = ParamSpec(L + (D, F_), ll + ("fsdp", "tp"), dt)
        s["wd"] = ParamSpec(L + (F_, D), ll + ("tp", "fsdp"), dt)
    if cfg.qk_norm:
        s["qnorm"] = ParamSpec(L + (dh,), ll + (None,), dt, init_scale=0.0)
        s["knorm"] = ParamSpec(L + (dh,), ll + (None,), dt, init_scale=0.0)
    if cfg.alt_local_global:                 # gemma2 post-norms
        s["ln1b"] = ParamSpec(L + (D,), ll + (None,), dt, init_scale=0.0)
        s["ln2b"] = ParamSpec(L + (D,), ll + (None,), dt, init_scale=0.0)
    return s


def param_specs(cfg: ArchConfig) -> dict:
    check_supported(cfg)
    dt = dtype_of(cfg.param_dtype)
    D = cfg.d_model
    s = {
        "embed": ParamSpec((cfg.vocab, D), ("tp", "fsdp"), dt),
        "ln_f": ParamSpec((D,), (None,), dt, init_scale=0.0),
        "blocks": block_specs(cfg),
    }
    if not cfg.tie_embeddings:
        s["unembed"] = ParamSpec((D, cfg.vocab), ("fsdp", "tp"), dt)
    if cfg.family == "vlm":
        s["img_proj"] = ParamSpec((cfg.frontend_dim, D), (None, "fsdp"), dt)
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


def _heads(cfg, y, heads: int, *, every: bool = False):
    """A column-parallel projection's output (B, S, columns) as heads
    (B, S, h, dh): outside a mesh program every head; under one this
    rank's ``heads / N`` where ``heads`` divides over the model axis, else
    every head, the columns all-gathered over it first (the reference
    replicates such heads: ``lm.py`` pins them by heads only where they
    divide).  ``every``: every head under a mesh program too (the slotted
    decode, whose lanes split by position, attends every head on every
    rank)."""
    tp = model_axis()
    if tp is not None and (every or heads % tp.world):
        y = model_all_gather(y, -1, tp.group)
    return y.reshape(y.shape[0], y.shape[1], -1, cfg.head_dim)


def _kv_reads(cfg):
    """Under a mesh program where the q heads divide over the model axis
    and the kv heads do not (so k and v hold every kv head): the kv heads
    this rank's q heads read (q head ``h`` reads kv head ``h // rep``), as
    ``(lo, hi)`` where they are a contiguous run each read by the same
    number of local q heads (that number is the kernel's ``rep``), else
    the list of one kv head per local q head (``rep`` 1).  None wherever
    k and v already hold what the local q heads read."""
    tp = model_axis()
    H, Hk = cfg.n_heads, cfg.n_kv
    if tp is None or H % tp.world or not Hk % tp.world:
        return None
    rep, hl = H // Hk, H // tp.world
    ids = [h // rep for h in range(tp.rank * hl, (tp.rank + 1) * hl)]
    lo, hi = ids[0], ids[-1] + 1
    if all(ids.count(u) == hl // (hi - lo) for u in range(lo, hi)):
        return lo, hi
    return ids


def _local_kv(cfg, k, v):
    """k and v (B, S, heads, dh) narrowed to the kv heads this rank's q
    heads read (:func:`_kv_reads`): a contiguous run, or one per local q
    head (``rep`` 1).  Never every kv head, which would change ``rep``."""
    reads = _kv_reads(cfg)
    if reads is None:
        return k, v
    if isinstance(reads, tuple):
        lo, hi = reads
        return k[:, :, lo:hi].contiguous(), v[:, :, lo:hi].contiguous()
    idx = torch.tensor(reads, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _attn_proj(cfg, h, bp, rope_cs, *, every: bool = False):
    """q, k, v of one layer; ``rope_cs`` = ``rope_tables`` of the
    positions, computed once per forward.  Under a mesh program ``h`` is
    the whole sequence, q this rank's heads and k, v the kv heads as the
    paged pool holds them: this rank's where they divide over the model
    axis, else every one (:func:`_heads`; :func:`_local_kv` then narrows
    them to what the local q heads read).  ``every``: every head of each."""
    q = _heads(cfg, h @ _w(bp, "wq", cfg), cfg.n_heads, every=every)
    k = _heads(cfg, h @ _w(bp, "wk", cfg), cfg.n_kv, every=every)
    v = _heads(cfg, h @ _w(bp, "wv", cfg), cfg.n_kv, every=every)
    if cfg.qk_norm:
        q = norm(cfg, q, bp["qnorm"])
        k = norm(cfg, k, bp["knorm"])
    q = apply_rope(q, *rope_cs)
    if _q_scale(cfg) != 1.0:
        q = q * _q_scale(cfg)
    k = apply_rope(k, *rope_cs)
    return q, k, v


def _attn_o(cfg, o, bp, *, every: bool = False):
    """The attention output projection of (..., heads x dh): under a mesh
    program a row-parallel product of this rank's heads (of its rows of
    every head's output where the heads do not divide, or with
    ``every``), reduced back into the residual layout
    (``common.tp_exit``)."""
    tp = model_axis()
    if tp is not None and (every or cfg.n_heads % tp.world):
        c = o.shape[-1] // tp.world
        o = o[..., tp.rank * c:(tp.rank + 1) * c]
    return tp_exit(o @ _w(bp, "wo", cfg))


def _ffn(cfg, x, bp, aux_sink=None):
    """The block's FFN: SwiGLU/GeGLU, or under MoE ``moe_ffn`` over every
    row of ``x``; its aux dict is appended to ``aux_sink`` where one is
    given.  Under a mesh program the dense FFN is column-parallel into this
    rank's hidden columns and row-parallel out (``x`` in the residual
    layout, the whole sequence gathered first), and ``moe_ffn`` runs the
    rank's experts."""
    if cfg.moe.num_experts:
        out, aux = moe_ffn(x, bp["router"], bp["wg_e"], bp["wu_e"], bp["wd_e"], cfg=cfg)
        if aux_sink is not None:
            aux_sink.append(aux)
        return out
    x = tp_enter(x)
    g = x @ _w(bp, "wg", cfg)
    u = x @ _w(bp, "wu", cfg)
    return tp_exit((_gate(cfg, g) * u) @ _w(bp, "wd", cfg))


def _block_fwd(cfg, x, bp, rope_cs, *, window: int, attn_fn=None, aux_sink=None):
    """One transformer block, prefill path.  Returns (x, (k, v)), k and v
    as :func:`_attn_proj` gives them (under a mesh program the paged
    pool's layout).  ``attn_fn(q, k, v, window)`` replaces the attention (a
    chunked-prefill continuation's, :func:`_block_chunk`); everything
    around it is shared.  Under a mesh program ``x`` is in the residual
    layout (this rank's sequence shard where the rules shard it; the norms
    run on it) and the attention this rank's heads over the whole
    sequence."""
    h = tp_enter(norm(cfg, x, bp["ln1"]))
    q, k, v = _attn_proj(cfg, h, bp, rope_cs)
    if attn_fn is not None:
        attn = attn_fn(q, k, v, window)
    else:
        kl, vl = _local_kv(cfg, k, v)
        if cfg.attn_impl == "kernel":
            from repro_torch.kernels.flash_attention.ops import flash_attention
            attn = flash_attention(q, kl, vl, causal=True, window=window,
                                   softcap=cfg.attn_softcap)
        else:
            attn = chunked_attention(
                q, kl, vl, causal=True, window=window, softcap=cfg.attn_softcap,
                q_chunk=min(256, q.shape[1]), kv_chunk=min(256, kl.shape[1]))
    B, S = attn.shape[:2]
    h, x = _attn_out(cfg, x, _attn_o(cfg, attn.reshape(B, S, -1), bp), bp)
    return _ffn_out(cfg, x, _ffn(cfg, h, bp, aux_sink), bp), (k, v)


def _block_decode(cfg, x, bp, kc, vc, cur_index, rope_cs, *, window: int, attn_fn=None,
                  seq_group=None):
    """One block, single-token decode.  x: (B, D).  ``attn_fn(q, kc, vc,
    k_new, v_new, window, reads)`` replaces the slotted cache write +
    attention (the paged path; ``reads`` is :func:`_kv_reads`); everything
    around it is shared, so the layouts stay numerically identical.
    ``rope_cs``: ``rope_tables`` of the lanes' positions (B, 1), computed
    once per step.  Returns x; kc/vc are written in place.

    Under a mesh program the residual stream is whole on every rank.  The
    slotted cache holds this rank's positions of its lanes and every kv
    head, so q, k and v are gathered to every head and the attention
    combines the partials of ``seq_group``'s ranks
    (``decode_attention(seq_group=)``); the
    paged pool holds this rank's kv heads where they divide, so the
    attention runs on the local heads (:func:`_heads`), as the prefill's
    does.  Both end in the row-parallel output projection."""
    dh = cfg.head_dim
    B = x.shape[0]
    tp = model_axis()
    every = tp is not None and attn_fn is None
    h = tp_enter(norm(cfg, x, bp["ln1"]))[:, None]
    q, k, v = _attn_proj(cfg, h, bp, rope_cs, every=every)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    reads = None if every else _kv_reads(cfg)
    n_kv = k.shape[1] if reads is None else (
        reads[1] - reads[0] if isinstance(reads, tuple) else len(reads))
    q = q.reshape(B, n_kv, q.shape[1] // n_kv, dh)
    if attn_fn is None:
        attn = decode_attention(q, kc, vc, k, v, cur_index, window=window,
                                softcap=cfg.attn_softcap, seq_group=seq_group)
    else:
        attn = attn_fn(q, kc, vc, k, v, window, reads)
    h, x = _attn_out(cfg, x, _attn_o(cfg, attn.reshape(B, -1), bp, every=every), bp)
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
    """The tokens' embeddings.  Under a mesh program the table is this
    rank's vocabulary rows: ids outside them give zero rows, and the
    ranks' partial rows are reduced onto the rank's sequence shard
    (``common.tp_exit``)."""
    cdt = dtype_of(cfg.compute_dtype)
    w = use(cfg, params, "embed")
    tp = model_axis()
    if tp is None:
        x = F.embedding(tokens.long(), w)
    else:
        ids = tokens.long() - tp.rank * w.shape[0]
        inside = (ids >= 0) & (ids < w.shape[0])
        x = torch.where(inside[..., None], F.embedding(ids.clamp(0, w.shape[0] - 1), w), 0.0)
    if cfg.alt_local_global:
        # gemma scales embeddings, the scale rounded to cdt first (a Python
        # float: no host-to-device copy, so a decode graph can capture it;
        # the product is taken in fp32 and rounded, as a cdt x cdt one is)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt).item()
    return tp_exit(x)


def unembed(cfg, params, x):
    """Logits of hidden states ``x``: under a mesh program this rank's
    vocabulary columns of them (``x`` the whole sequence)."""
    w = use(cfg, params, "embed").t() if cfg.tie_embeddings else use(cfg, params, "unembed")
    logits = x @ w
    if cfg.logit_softcap:
        logits = softcap(logits.float(), cfg.logit_softcap)
    return logits


def forward(cfg: ArchConfig, params, tokens, img_embeds=None, *, remat=True,
            collect_kv: bool = False, aux: dict | None = None):
    """tokens (B, S) -> (final-normed hidden (B, S, D), kv or None) with kv
    = (k, v) stacked over layers: (lead..., B, S, Hk, dh) each.  Under the
    vlm family ``img_embeds`` (B, N, frontend_dim) are projected by
    ``img_proj`` and prepended: S becomes N + S.  ``remat``
    (False | True | "dots", see ``common.remat_wrap``) wraps each block.
    ``aux``, where given, receives the reference forward's aux: the MoE
    layers' ``lb_loss`` summed and ``drop_frac`` maxed over layers (0 for
    dense models), and each MoE layer's ``drop_frac`` in order
    (``drop_frac_layers``, (L,) or empty).  Under a mesh program (the
    families of ``TP_FAMILIES``) the hidden states are this rank's
    sequence shard where the rules shard the sequence."""
    check_supported(cfg)
    tp = model_axis()
    if tp is not None and cfg.family not in (TP_FAMILIES if tp.sp else SERVE_TP_FAMILIES):
        raise NotImplementedError(f"{cfg.name}: the model axis is not ported for the "
                                  f"{cfg.family!r} family")
    sink = [] if aux is not None else None
    x = embed_tokens(cfg, params, tokens)
    if cfg.family == "vlm":
        cdt = dtype_of(cfg.compute_dtype)
        img = img_embeds.to(cdt) @ use(cfg, params, "img_proj")
        x = torch.cat([img, x], dim=1)
    B, S = x.shape[0], tokens.shape[1] + (img.shape[1] if cfg.family == "vlm" else 0)
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    def body(x, bp, window):
        # inside the remat: the recompute gathers the layer's shards again
        bp = use_layer(cfg, bp, ("blocks",), len(_leading(cfg)))
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
    """Next-token loss on ``batch["tokens"]`` (B, S + 1) (and, for the vlm
    family, ``batch["patch_embeds"]``: the loss reads the hidden states
    from the last image position on, ``[N - 1, N - 1 + S)``).  Returns
    ``(total, {"ce_loss", "lb_loss", "drop_frac"})``, the reference's:
    ``total = ce_loss + 1e-2 * lb_loss / n_layers`` with the MoE layers'
    ``lb_loss`` summed and ``drop_frac`` their maximum (both 0 for the
    other families, so total == ce_loss).  Under a mesh program the loss
    is the vocab-parallel cross entropy of this rank's logit columns over
    the whole sequence (``common.vocab_parallel_cross_entropy``)."""
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    aux: dict = {}
    hidden, _ = forward(cfg, params, inp, batch.get("patch_embeds"), remat=remat, aux=aux)
    if cfg.family == "vlm":
        n = cfg.frontend_tokens
        hidden = hidden[:, n - 1: n - 1 + labels.shape[1]]
    tp = model_axis()
    if tp is None:
        loss = cross_entropy_loss(unembed(cfg, params, hidden), labels)
    else:
        logits = unembed(cfg, params, tp_enter(hidden))
        loss = vocab_parallel_cross_entropy(logits, labels, tp.group)
    total = loss + 1e-2 * aux["lb_loss"] / max(cfg.n_layers, 1)
    return total, {"ce_loss": loss, "lb_loss": aux["lb_loss"], "drop_frac": aux["drop_frac"]}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
#
# Under a serving mesh program (``common.serve_program``) every rank holds
# the whole residual stream; the weights are this rank's model slices,
# gathered over ``data`` a layer at a time.  The caches hold this rank's
# part, as the reference lays them out (``cache_pspec``,
# ``paged_cache_pspec``):
#
# * slotted (``attention.DecodeSharding``): the lanes over the data axes
#   where ``max_slots`` divides over them, each lane's positions over
#   ``model``; else (the batch fallback) every lane on every rank, its
#   positions over every rank.  A decode step embeds and walks this rank's
#   lanes and gathers their logits over the data axes; a prefill of one
#   lane runs its forward on every data rank (the weights' gathers over
#   ``data`` are collectives every rank joins) and the lane's owner writes.
# * paged: the pool's kv heads over ``model`` where they divide, its blocks
#   over the data axes (the engine rounds the pool up to the data size).
#   The block table stays global and replicated: a write lands on the rank
#   that holds its block, every rank attends every lane over the blocks it
#   holds and the ranks' partials merge by log-sum-exp
#   (``attention.data_combine``), a continuation chunk gathers its lane
#   over ``data`` (``attention.gather_lane``), and a copy-on-write moves a
#   block between the ranks that hold ``src`` and ``dst``.
#
# Logits leave every serving function whole on every rank (gathered over
# ``model``, and over the data axes where the lanes split), so every rank
# samples the same ``(B, V)``.


def _decode_sharding():
    """The slotted cache's ``DecodeSharding`` under a serving mesh program
    (None outside one, or for a paged engine's)."""
    split = serve_split()
    return None if split is None else split.decode


def _seq_group():
    """The group a slotted lane's positions split over (None: whole)."""
    dec = _decode_sharding()
    return None if dec is None else dec.seq_group


def _local_lanes(batch: int) -> tuple[int, int]:
    """``[lo, hi)``: the lanes of ``batch`` this rank holds."""
    dec = _decode_sharding()
    return (0, batch) if dec is None else dec.local_lanes(batch)


def _gather_lanes(logits):
    """Logits of this rank's lanes as every lane's: gathered over the data
    axes where the lanes split over them."""
    dec = _decode_sharding()
    if dec is None or not dec.batch_axes:
        return logits
    return data_all_gather(logits, 0, dec.mesh.data)


def _data_group():
    """The data group a paged pool's blocks split over under a serving mesh
    program (None outside one)."""
    split = serve_split()
    return None if split is None else split.mesh.data


def _write_blocks(pool):
    """The global blocks ``(lo, n)`` of a paged pool (or a layer's view of
    one, blocks on axis ``dim - 4``) that a write into it honours: the
    rank's share, or None wherever the rank holds every block."""
    g = _data_group()
    if g is None or g.world == 1:
        return None
    n = pool.shape[-4]
    return g.rank * n, n


def cache_pspec(cfg: ArchConfig, dec: DecodeSharding | None = None) -> dict:
    """The slotted cache's layout under ``dec`` (``DecodeSharding.choose(mesh,
    max_slots)``), the reference's ``cache_pspec``: one entry (None or a
    tuple of axis names) per dimension of (lead..., B, S, Hk, dh), the
    lanes over ``dec.batch_axes``, the positions over ``dec.seq_axes``."""
    lead = (None,) * len(_leading(cfg))
    if dec is None:
        spec = lead + (None,) * 4
    else:
        spec = lead + (dec.batch_axes or None, dec.seq_axes or None, None, None)
    return {"k": spec, "v": spec}


def paged_cache_pspec(cfg: ArchConfig, mesh=None) -> dict:
    """The paged pool's layout on ``mesh``, the reference's
    ``paged_cache_pspec``: the blocks over the data axes (the pool must
    divide over them: the engine rounds it up, as the reference's), kv
    heads over ``model`` where they divide, else whole."""
    lead = (None,) * len(_leading(cfg))
    if mesh is None:
        return {"k": lead + (None,) * 4, "v": lead + (None,) * 4}
    dp = tuple(a for a in ("pod", "data") if a in mesh.axes) or None
    tp = ("model",) if ("model" in mesh.axes and cfg.n_kv % mesh.size("model") == 0) else None
    spec = lead + (dp, None, tp, None)
    return {"k": spec, "v": spec}


def _local_specs(cfg, shape, specs, mesh) -> dict:
    """Meta tensors of this rank's part of leaves of ``shape`` laid out by
    ``specs`` (per dimension None or a tuple of axis names) on ``mesh``."""
    out = {}
    for name, spec in specs.items():
        local = []
        for n, axes in zip(shape, spec):
            if axes is not None:
                m = math.prod(mesh.size(a) for a in axes)
                if n % m:
                    raise ValueError(f"{cfg.name}: {n} does not divide over {m} ranks of "
                                     f"{axes} (cache leaf {name} {tuple(shape)})")
                n //= m
            local.append(n)
        out[name] = torch.empty(local, dtype=dtype_of(cfg.compute_dtype), device="meta")
    return out


def make_cache_specs(cfg: ArchConfig, batch: int, max_len: int, mesh=None) -> dict:
    """Slotted KV cache (lead..., B, S, Hk, dh) as meta tensors (shape +
    dtype): on ``mesh`` this rank's part (:func:`cache_pspec` of
    ``DecodeSharding.choose(mesh, batch)``): ``batch / ndp`` lanes of
    ``max_len / M`` positions each, or, where ``batch`` does not divide
    over the data axes, every lane with ``max_len / world`` positions
    (``max_len`` must divide)."""
    dec = None
    if mesh is not None:
        dec = DecodeSharding.choose(mesh, batch)
        dec.local_len(max_len)
    shape = _leading(cfg) + (batch, max_len, cfg.n_kv, cfg.head_dim)
    return _local_specs(cfg, shape, cache_pspec(cfg, dec), mesh)


def lane_leaf_axes(cfg: ArchConfig) -> dict:
    """``{cache leaf: lane axis}`` of the slotted cache: everything one lane
    owns, the host tier's unit of a whole-lane spill.  Both leaves put the
    lane right after the leading layer axes."""
    lead = len(_leading(cfg))
    return {"k": lead, "v": lead}


def make_paged_cache_specs(cfg: ArchConfig, num_blocks: int, block_size: int,
                           mesh=None) -> dict:
    """Paged KV pool (lead..., NB, bs, Hk, dh) as meta tensors: on ``mesh``
    this rank's part (:func:`paged_cache_pspec`), ``NB / ndp`` blocks."""
    shape = _leading(cfg) + (num_blocks, block_size, cfg.n_kv, cfg.head_dim)
    return _local_specs(cfg, shape, paged_cache_pspec(cfg, mesh), mesh)


def copy_paged_block(cfg: ArchConfig, cache, src: int, dst: int):
    """Copy physical pool block ``src`` to ``dst`` in every cache leaf, in
    place: the prefix cache's copy-on-write step (a new request's prompt
    covers a shared block whole but must rewrite its tail position, since
    the sampling position is always recomputed; the lane gets the private
    copy).  Leaves are (lead..., NB, bs, Hk, dh); the block axis is
    ``ndim - 4``.  One indexed copy per leaf, on the current stream, so it
    is ordered before the continuation chunk that overwrites the copy's
    tail.  Under a serving mesh program whose data axes split the blocks
    the copy runs on the rank that holds both, or ``src``'s holder
    broadcasts the block (every leaf in one tensor, counted in
    ``common.COUNTS["block_copy"]``) over the data group and ``dst``'s
    holder writes it: every rank calls this, as every rank runs the
    schedule."""
    leaves = list(cache.values())
    axis = leaves[0].dim() - 4
    blocks = _write_blocks(leaves[0])
    if blocks is None:
        for c in leaves:
            c.select(axis, dst).copy_(c.select(axis, src))
        return cache
    g = _data_group()
    n = blocks[1]
    (so, sl), (do, dl) = divmod(src, n), divmod(dst, n)
    if so == do:
        if g.rank == so:
            for c in leaves:
                c.select(axis, dl).copy_(c.select(axis, sl))
        return cache
    if g.rank == so:
        buf = torch.stack([c.select(axis, sl) for c in leaves])
    else:
        buf = torch.empty((len(leaves),) + tuple(leaves[0].select(axis, 0).shape),
                          dtype=leaves[0].dtype, device=leaves[0].device)
    dist.broadcast(buf, src=dist.get_global_rank(g.pg, so), group=g.pg)
    COUNTS["block_copy"] += 1
    if g.rank == do:
        for c, b in zip(leaves, buf):
            c.select(axis, dl).copy_(b)
    return cache


def serve_logits(cfg: ArchConfig, params, x):
    """Logits of hidden states ``x`` for sampling: under a mesh program the
    ranks' vocabulary columns gathered over the model axis, so every rank
    holds the whole ``(..., V)``."""
    logits = unembed(cfg, params, x)
    tp = model_axis()
    return logits if tp is None else model_all_gather(logits, -1, tp.group)


def _slotted_kv(cfg, t):
    """Collected k or v (..., S, heads, dh) as the slotted cache stores
    them: every kv head (gathered over the model axis where it splits
    them)."""
    tp = model_axis()
    if tp is not None and not cfg.n_kv % tp.world:
        return model_all_gather(t, -2, tp.group)
    return t


def _seq_part(s_loc: int, S: int) -> tuple[int, int]:
    """``(start, n)``: this rank's positions ``[start, start + n)`` of
    positions ``[0, S)``, its cache holding ``s_loc`` of each lane from
    ``rank s_loc`` on, its rank the one in the lanes' sequence group (all
    of them outside a mesh program; none, from ``S`` on, where the rank's
    positions all lie past ``S``)."""
    g = _seq_group()
    start = 0 if g is None else min(g.rank * s_loc, S)
    return start, max(0, min(S - start, s_loc))


def prefill(cfg: ArchConfig, params, tokens, img_embeds=None, *,
            max_len: int | None = None):
    """Whole-batch prefill: tokens (B, S) -> (slotted cache {k, v} of
    (lead..., B, max_len, Hk, dh), the KV of positions [0, S) and zeros past it;
    logits (B, V) at the last position).  vlm: ``img_embeds`` lead the
    sequence, so the KV covers N + S positions.  Under a serving mesh
    program the cache is this rank's part (:func:`make_cache_specs`): the
    forward runs on the rank's lanes and their logits are gathered over
    the data axes."""
    B = tokens.shape[0]
    lo, hi = _local_lanes(B)
    if (lo, hi) != (0, B):
        tokens = tokens[lo:hi]
        img_embeds = None if img_embeds is None else img_embeds[lo:hi]
    hidden, (k, v) = forward(cfg, params, tokens, img_embeds, remat=False, collect_kv=True)
    S = k.shape[-3]
    L = max(max_len or S, S)
    dec = _decode_sharding()
    s_loc = L if dec is None else dec.local_len(L)
    start, n = _seq_part(s_loc, S)
    cache = {}
    for name, t in (("k", k), ("v", v)):
        t = _slotted_kv(cfg, t).narrow(-3, start, n)
        cache[name] = F.pad(t, [0, 0, 0, 0, 0, s_loc - n])
    return cache, _gather_lanes(serve_logits(cfg, params, hidden[:, -1]))


def prefill_slot(cfg: ArchConfig, params, cache, tokens, slot: int, plen: int):
    """Prefill ONE prompt into lane ``slot`` of the slotted cache.

    tokens: (1, S_bucket) — the prompt right-padded to its bucket; the
    whole padded bucket is written into the lane (causality makes the
    padding inert, and decode overwrites the tail before reading it;
    under a mesh program this rank's positions of it).  Under a serving
    mesh program whose data axes split the lanes, every rank runs the
    forward and the k, v gathers, and only the rank holding ``slot``
    writes it, at its index among the rank's lanes.
    Returns (cache, logits (1, V) at position plen-1); cache in place.
    """
    hidden, (k, v) = forward(cfg, params, tokens, remat=False, collect_kv=True)
    S = tokens.shape[1]
    n_lanes = cache["k"].shape[-4]
    dec = _decode_sharding()
    lo = 0 if dec is None else dec.local_lanes(n_lanes * dec.lane_ranks)[0]
    for name, new in (("k", k), ("v", v)):
        start, n = _seq_part(cache[name].shape[-3], S)
        new = _slotted_kv(cfg, new).select(-4, 0).narrow(-3, start, n)
        if lo <= slot < lo + n_lanes:
            cache[name][..., slot - lo, :n, :, :] = new.to(cache[name].dtype)
    last = min(max(plen - 1, 0), S - 1)
    return cache, serve_logits(cfg, params, hidden[:, last])


def prefill_slot_paged(cfg: ArchConfig, params, cache, tokens, table_row, plen: int):
    """Prefill positions [0, C) of one lane into the paged pool through its
    block table.  Same ``forward`` as :func:`prefill_slot` (so slotted and
    paged prefills are bitwise equal); positions ``>= plen`` go to the
    sink block 0.  Under a serving mesh program every rank runs the
    forward and writes the positions whose blocks it holds.  Returns
    (cache, logits (1, V) at ``min(plen, C) - 1``)."""
    hidden, (k, v) = forward(cfg, params, tokens, remat=False, collect_kv=True)
    C = tokens.shape[1]
    pos = torch.arange(C, device=tokens.device)
    valid = pos < plen
    for name, new in (("k", k), ("v", v)):
        paged_write_positions(_flat_layers(cfg, cache[name]), table_row, pos,
                              _flat_layers(cfg, new).select(1, 0), valid,
                              blocks=_write_blocks(cache[name]))
    last = min(max(plen - 1, 0), C - 1)
    return cache, serve_logits(cfg, params, hidden[:, last])


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
    Under a mesh program the pools hold this rank's kv heads (or every
    one), and the lane's are narrowed to what the local q heads read; the
    pools' blocks are this rank's share, each write lands on the rank
    holding its block and the lane is gathered over the data axes
    (``attention.gather_lane``).  Returns x."""
    C = x.shape[1]
    pos = start + torch.arange(C, device=x.device)
    valid = pos < plen
    group = _data_group()
    owned = _write_blocks(kp)

    def attn_fn(q, k, v, w):
        paged_write_positions(kp, table_row, pos, k[0], valid, blocks=owned)
        paged_write_positions(vp, table_row, pos, v[0], valid, blocks=owned)
        kl, vl = _local_kv(cfg, gather_lane(kp, table_row, group),  # (1, nb*bs, Hk, dh)
                           gather_lane(vp, table_row, group))
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
        x = _block_chunk(cfg, x, _use_layer(cfg, params, i), *_cache_layer(cfg, cache, i),
                         table_row, start, plen, rope_cs, window=_window(cfg, i))
    x = norm(cfg, x, params["ln_f"])
    last = min(max(plen - 1 - start, 0), C - 1)
    return cache, serve_logits(cfg, params, x[:, last])


def _use_layer(cfg, params, i):
    """Layer ``i``'s weights as a serving walk reads them (gathered over
    ``data`` under a mesh program, ``common.use_layer``)."""
    return use_layer(cfg, _layer(cfg, params, i), ("blocks",), len(_leading(cfg)))


def _decode_walk(cfg, params, cache, x, cur_index, attn_fn, seq_group=None):
    """Per-layer decode walk shared by the slotted and paged layouts; each
    layer reads and writes its slice ``cache[..][i]`` (a view) in place."""
    check_supported(cfg)
    pos = decode_positions(cur_index, x.shape[0], x.device)
    rope_cs = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = _block_decode(cfg, x, _use_layer(cfg, params, i), *_cache_layer(cfg, cache, i),
                          cur_index, rope_cs, window=_window(cfg, i), attn_fn=attn_fn,
                          seq_group=seq_group)
    x = norm(cfg, x, params["ln_f"])
    return serve_logits(cfg, params, x), cache


def decode_step(cfg: ArchConfig, params, cache, tokens, cur_index):
    """tokens: (B,) int32; cur_index: tokens already in the cache, a
    scalar or a (B,) vector.  Returns (logits (B, V), cache).  Under a
    serving mesh program the step embeds and walks this rank's lanes (its
    rows of ``tokens`` and ``cur_index``), each layer's attention
    combining the ranks of the lanes' sequence group, and the logits are
    every lane's (gathered over the data axes where the lanes split)."""
    B = tokens.shape[0]
    lo, hi = _local_lanes(B)
    if (lo, hi) != (0, B):
        tokens = tokens[lo:hi]
        if torch.is_tensor(cur_index) and cur_index.dim() == 1:
            cur_index = cur_index[lo:hi]
    x = embed_tokens(cfg, params, tokens)
    logits, cache = _decode_walk(cfg, params, cache, x, cur_index, None,
                                 seq_group=_seq_group())
    return _gather_lanes(logits), cache


def decode_step_paged(cfg: ArchConfig, params, cache, tokens, lengths, tables,
                      *, impl: str = "ref"):
    """Paged decode: cache leaves are pools (lead..., NB, bs, Hk, dh); ``tables``
    (B, nb) maps lanes' logical blocks to pool blocks and ``lengths`` (B,)
    is both the RoPE position and the write position of the new token.
    ``impl``: "ref" (gather + masked softmax) or "kernel" (the
    block-walking CUDA kernel).  Under a mesh program the pool's kv heads
    are this rank's (or every one, of which the attention reads the run
    the local q heads read: a head slice of the pool) and its blocks the
    rank's share: every rank attends every lane over its blocks and the
    data ranks' partials merge (``attention.paged_decode_attention``'s
    ``data_group``).  Returns (logits (B, V), cache)."""
    x = embed_tokens(cfg, params, tokens)

    def attn_fn(q, kc, vc, k_new, v_new, window, reads):
        if isinstance(reads, list):
            raise NotImplementedError(
                f"{cfg.name}: the kv heads a rank's q heads read are not one even run "
                "at this model axis; the paged decode takes a run of the pool's heads")
        return paged_decode_attention(
            q, kc, vc, k_new, v_new, lengths, tables,
            window=window, softcap=cfg.attn_softcap, impl=impl, kv_heads=reads,
            data_group=_data_group())

    return _decode_walk(cfg, params, cache, x, lengths, attn_fn)
