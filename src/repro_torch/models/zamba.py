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

On the ``(data, model)`` mesh (``common.model_axis``; the reference's
layouts): the shared block is Megatron-style, ``proj_in`` whole over
``model`` and its output entering the tensor-parallel region, the q, k,
v, gate and up projections column-parallel into the rank's heads and FFN
columns, the output and down projections row-parallel out; the embedding
and unembedding are vocab-parallel, with the vocab-parallel loss; the
Mamba2 blocks as ``ssm.py`` lays out (heads split in training, every head
in serving).  The residual stream stays whole over ``model``: the
reference turns ``sp`` off for this family.  Leaves replicated over
``model`` but read per head inside the region (``TP_REGION_LEAVES``) hold
a partial gradient on each model rank.  Serving holds the reference's
``cache_pspec``: ``k``/``v`` lanes over the data axes and positions over
``model`` (``attention.DecodeSharding``, the batch fallback included),
``ssm``/``conv`` lanes over the data axes and whole over ``model``.

Simplifications vs the released checkpoints (as in the reference): the
per-invocation LoRA deltas on the shared block are omitted; the shared
block's attention operates at d_model (after the concat projection).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from . import lm
from .attention import (
    DecodeSharding,
    apply_rope,
    chunked_attention,
    decode_attention,
    rope_tables,
)
from .common import (
    ParamSpec,
    cast_tree,
    cross_entropy_loss,
    decode_positions,
    dtype_of,
    init_tree,
    model_all_gather,
    model_axis,
    norm,
    norm_add,
    remat_wrap,
    tp_enter,
    tp_exit,
    use,
    use_layer,
    vocab_parallel_cross_entropy,
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
# the residual stream is whole over the model axis (the reference's
# launcher turns ``sp`` off for the hybrid family)
SEQUENCE_PARALLEL = False
# leaves replicated over the model axis but read per head inside the
# tensor-parallel region (each Mamba2 rank's heads): a partial gradient on
# each model rank, summed over it
TP_REGION_LEAVES = frozenset({"dt_bias", "A_log", "D_skip", "out_ln"})


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
    """The shared block's MLP: under a mesh program column-parallel into
    the rank's hidden columns and row-parallel out."""
    h = tp_enter(h)
    g = h @ _w(sp, "wg", cfg)
    u = h @ _w(sp, "wu", cfg)
    return tp_exit((F.silu(g) * u) @ _w(sp, "wd", cfg))


def _prefill_rope(cfg, B, S, device):
    positions = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def _shared_in(cfg, x, x0, sp):
    """``proj_in`` of ``[ln1(x), x0]``, as the block's column-parallel
    products read it (``proj_in`` is whole over the model axis: its output
    enters the tensor-parallel region)."""
    return tp_enter(torch.cat([norm(cfg, x, sp["ln1"]), x0], dim=-1) @ _w(sp, "proj_in", cfg))


def _shared_fwd(cfg, x, x0, sp, rope_cs=None):
    """Shared transformer block, prefill.  x/x0: (B,S,D).  Returns
    (x', (k, v)) with k after RoPE.  ``rope_cs``: the positions'
    ``rope_tables``, which a forward computes once for every invocation
    (made here when left None).  Under a mesh program q, k and v are the
    rank's heads (``lm._heads``; ``lm._local_kv`` narrows k and v to what
    they read) and the output projection row-parallel."""
    B, S, _ = x.shape
    # each invocation gathers; not rematted, so its products keep the
    # shards for the backward, which gathers again (common._pack)
    sp = use_layer(cfg, sp, ("shared",), lead=0)
    u = _shared_in(cfg, x, x0, sp)
    if rope_cs is None:
        rope_cs = _prefill_rope(cfg, B, S, x.device)
    q = lm._heads(cfg, u @ _w(sp, "wq", cfg), cfg.n_heads)
    k = lm._heads(cfg, u @ _w(sp, "wk", cfg), cfg.n_kv)
    v = lm._heads(cfg, u @ _w(sp, "wv", cfg), cfg.n_kv)
    q = apply_rope(q, *rope_cs)
    kr = apply_rope(k, *rope_cs)
    kl, vl = lm._local_kv(cfg, kr, v)
    if cfg.attn_impl == "kernel":
        from repro_torch.kernels.flash_attention.ops import flash_attention
        attn = flash_attention(q, kl, vl, causal=True)
    else:
        attn = chunked_attention(q, kl, vl, causal=True,
                                 q_chunk=min(256, S), kv_chunk=min(256, S))
    o = lm._attn_o(cfg, attn.reshape(B, S, -1), sp)
    h, x = norm_add(cfg, x, o, sp["ln2"])
    return x + _mlp(cfg, h, sp), (kr, v)


def _decode_rope(cfg, cur_index, B, device):
    # scalar (aligned batch) or (B,) vector (slotted serve: per-lane
    # positions) — decode_attention handles both
    return rope_tables(decode_positions(cur_index, B, device), cfg.head_dim, cfg.rope_theta)


def _shared_decode(cfg, x, x0, sp, kc, vc, cur_index, rope_cs=None, seq_group=None):
    """Shared block, one token per lane.  x/x0: (B,D); kc/vc (B,S,Hk,dh)
    are written in place at ``cur_index``.  ``rope_cs`` as in
    :func:`_shared_fwd`, of the lanes' positions.  Under a serving mesh
    program the slotted cache holds this rank's positions of every kv head
    (its lanes'): q, k and v are gathered to every head, the attention
    combines the partials of ``seq_group``'s ranks and the output
    projection takes this rank's rows of every head's output, as
    ``lm._block_decode``'s slotted path."""
    B = x.shape[0]
    dh, H, Hk = cfg.head_dim, cfg.n_heads, cfg.n_kv
    every = model_axis() is not None
    u = _shared_in(cfg, x, x0, sp)[:, None]
    q = lm._heads(cfg, u @ _w(sp, "wq", cfg), H, every=every)[:, 0]
    k = lm._heads(cfg, u @ _w(sp, "wk", cfg), Hk, every=every)[:, 0]
    v = lm._heads(cfg, u @ _w(sp, "wv", cfg), Hk, every=every)[:, 0]
    if rope_cs is None:
        rope_cs = _decode_rope(cfg, cur_index, B, x.device)
    q = apply_rope(q[:, None], *rope_cs)[:, 0].reshape(B, Hk, H // Hk, dh)
    k = apply_rope(k[:, None], *rope_cs)[:, 0]
    attn = decode_attention(q, kc, vc, k, v, cur_index, seq_group=seq_group)
    o = lm._attn_o(cfg, attn.reshape(B, H * dh), sp, every=every)
    h, x = norm_add(cfg, x, o, sp["ln2"])
    return x + _mlp(cfg, h, sp)


def _embed(cfg, params, tokens):
    """The tokens' embeddings: under a mesh program vocab-parallel
    (``lm.embed_tokens``)."""
    return lm.embed_tokens(cfg, params, tokens)


def _unembed(cfg, params, x):
    """Logits of ``x``: under a mesh program this rank's vocabulary
    columns."""
    return x @ use(cfg, params, "unembed")


def _logits(cfg, params, x):
    """Logits for sampling, whole on every rank: under a mesh program the
    ranks' vocabulary columns gathered over the model axis."""
    logits = _unembed(cfg, params, x)
    tp = model_axis()
    return logits if tp is None else model_all_gather(logits, -1, tp.group)


def _layer(params, i):
    return {name: p[i] for name, p in params["mamba"].items()}


def _use_layer(cfg, params, i):
    """Mamba2 layer ``i``'s weights as a walk outside the remat reads them
    (gathered over ``data`` under a mesh program, ``common.use_layer``)."""
    return use_layer(cfg, _layer(params, i), ("mamba",))


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
    tp = model_axis()
    if tp is not None and tp.sp:
        raise NotImplementedError(f"{cfg.name}: the hybrid family keeps its residual stream "
                                  "whole over the model axis (the reference's rules turn sp "
                                  "off for it)")
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
                x, (s, c) = mamba_block_fwd(cfg, x, _use_layer(cfg, params, i),
                                            return_state=True, valid=valid, state_len=plen)
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
    reference's.  Under a mesh program the vocab-parallel cross entropy of
    this rank's logit columns."""
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    hidden, _ = forward(cfg, params, inp, remat=remat)
    tp = model_axis()
    if tp is None:
        loss = cross_entropy_loss(_unembed(cfg, params, hidden), labels)
    else:
        loss = vocab_parallel_cross_entropy(_unembed(cfg, params, tp_enter(hidden)), labels,
                                            tp.group)
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


def cache_pspec(cfg: ArchConfig, dec: DecodeSharding | None = None) -> dict:
    """The composed cache's layout under ``dec`` (``DecodeSharding.choose(mesh,
    max_slots)``), the reference's ``cache_pspec``: one entry (None or a
    tuple of axis names) per dimension; ``k``/``v`` (n_shared, B, S, Hk, dh)
    with the lanes over ``dec.batch_axes`` and the positions over
    ``dec.seq_axes``, ``ssm`` and ``conv`` with the lanes over
    ``dec.batch_axes`` and whole over ``model``."""
    b = None if dec is None else dec.batch_axes or None
    s = None if dec is None else dec.seq_axes or None
    return {"k": (None, b, s, None, None), "v": (None, b, s, None, None),
            "ssm": (None, b, None, None, None), "conv": (None, b, None, None)}


def make_cache_specs(cfg: ArchConfig, batch: int, max_len: int, mesh=None) -> dict:
    """The composed hybrid cache as meta tensors: k/v (n_shared, batch,
    max_len, Hk, dh) in the compute dtype, ssm (L, batch, H, N, P) fp32,
    conv (L, batch, K-1, conv channels) in the compute dtype.  On ``mesh``
    this rank's part (:func:`cache_pspec` of ``DecodeSharding.choose(mesh,
    batch)``; ``max_len`` must divide over the ranks the positions split
    over)."""
    kv = torch.empty((n_shared_invocations(cfg), batch, max_len, cfg.n_kv, cfg.head_dim),
                     dtype=dtype_of(cfg.compute_dtype), device="meta")
    whole = {"k": kv, "v": kv, **mamba_state_specs(cfg, cfg.n_layers, batch)}
    if mesh is None:
        return whole
    dec = DecodeSharding.choose(mesh, batch)
    dec.local_len(max_len)
    out = {}
    for name, spec in cache_pspec(cfg, dec).items():
        shape = list(whole[name].shape)
        for d, axes in enumerate(spec):
            if axes is not None:
                shape[d] //= math.prod(mesh.size(a) for a in axes)
        out[name] = torch.empty(shape, dtype=whole[name].dtype, device="meta")
    return out


def _cache_kv(cfg, cache, name, S: int, s_loc: int):
    """Collected ``k`` or ``v`` (n_shared, B, S, heads, dh) as the slotted
    cache holds them: every kv head (``lm._slotted_kv``), this rank's
    ``s_loc`` positions of ``[0, S)`` (``lm._seq_part``) and the count of
    them that hold prompt positions."""
    start, n = lm._seq_part(s_loc, S)
    return lm._slotted_kv(cfg, cache[name]).narrow(2, start, n), n


def prefill(cfg, params, tokens, *, max_len: int | None = None):
    """tokens (B, S) -> (cache with k/v padded to ``max_len``, logits (B, V)
    at the last position).  Under a serving mesh program the cache is this
    rank's part (:func:`make_cache_specs`): the forward runs on the rank's
    lanes, the k/v positions are the rank's, and the logits are gathered
    over the data axes."""
    B = tokens.shape[0]
    lo, hi = lm._local_lanes(B)
    if (lo, hi) != (0, B):
        tokens = tokens[lo:hi]
    hidden, cache = forward(cfg, params, tokens, collect=True)
    S = tokens.shape[1]
    L = max(max_len or S, S)
    dec = lm._decode_sharding()
    s_loc = L if dec is None else dec.local_len(L)
    for name in ("k", "v"):
        t, n = _cache_kv(cfg, cache, name, S, s_loc)
        cache[name] = F.pad(t, [0, 0, 0, 0, 0, s_loc - n])
    return cache, lm._gather_lanes(_logits(cfg, params, hidden[:, -1]))


def decode_step(cfg, params, cache, tokens, cur_index):
    """tokens: (B,) int32; cur_index: tokens already in the cache, a scalar
    or a (B,) vector.  Returns (logits (B, V), cache), the cache updated in
    place.  Under a serving mesh program the step embeds and walks this
    rank's lanes (its rows of ``tokens`` and ``cur_index``), the shared
    block's attention combining the ranks of the lanes' sequence group,
    and the logits are every lane's."""
    check_supported(cfg)
    B = tokens.shape[0]
    lo, hi = lm._local_lanes(B)
    if (lo, hi) != (0, B):
        tokens = tokens[lo:hi]
        if torch.is_tensor(cur_index) and cur_index.dim() == 1:
            cur_index = cur_index[lo:hi]
    x = _embed(cfg, params, tokens)
    x0 = x
    rope_cs = _decode_rope(cfg, cur_index, x.shape[0], x.device)
    seq_group = lm._seq_group()
    off = 0
    for si, n in enumerate(_segments(cfg)):
        x = _shared_decode(cfg, x, x0, use_layer(cfg, params["shared"], ("shared",), lead=0),
                           cache["k"][si], cache["v"][si], cur_index, rope_cs, seq_group)
        for i in range(off, off + n):
            x, s, c = mamba_block_decode(cfg, x, _use_layer(cfg, params, i), cache["ssm"][i],
                                         cache["conv"][i])
            cache["ssm"][i] = s
            cache["conv"][i] = c
        off += n
    x = norm(cfg, x, params["ln_f"])
    return lm._gather_lanes(_logits(cfg, params, x)), cache


def prefill_slot(cfg, params, cache, tokens, slot: int, plen: int):
    """Prefill ONE prompt into lane ``slot`` of the composed hybrid cache.

    tokens: (1, S_bucket) right-padded.  The lane write covers both state
    kinds at once: the shared block's K/V land in the lane's seq slice
    ``[0, S_bucket)`` (padded tail inert by causality + lazy overwrite)
    and the mamba ``ssm``/``conv`` leaves land as the lane's recurrent
    snapshot at position ``plen`` (dt = 0 identity padding, see ssm.py).
    Returns (cache, logits (1, V) at position plen - 1); cache in place.

    Under a serving mesh program every rank runs the forward (the weights'
    gathers are collectives every rank joins) and only the rank holding
    ``slot`` writes it, at its index among the rank's lanes: its positions
    of the k/v segment and the whole recurrent snapshot.
    """
    hidden, col = forward(cfg, params, tokens, collect=True, plen=plen)
    S = tokens.shape[1]
    n_lanes = cache["k"].shape[1]
    dec = lm._decode_sharding()
    local = slot if dec is None else dec.local_slot(slot, n_lanes)
    for name in ("k", "v"):
        new, n = _cache_kv(cfg, col, name, S, cache[name].shape[2])
        if local is not None:
            cache[name][:, local, :n] = new[:, 0].to(cache[name].dtype)
    if local is not None:
        cache["ssm"][:, local] = col["ssm"][:, 0]
        cache["conv"][:, local] = col["conv"][:, 0].to(cache["conv"].dtype)
    return cache, _logits(cfg, params, hidden[:, plen - 1])
