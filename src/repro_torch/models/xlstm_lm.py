"""xLSTM-LM assembly [arXiv:2405.04517]: ``slstm_every - 1`` mLSTM blocks
followed by one sLSTM block, repeated (7:1 for xlstm-1.3b).

The port of the reference's ``models/xlstm_lm.py``.  Parameters keep the
reference's tree (mLSTM blocks stacked on axis 0 across segments, sLSTM
blocks likewise), so a converted JAX tree loads unchanged.  As in
``lm.py``, compute-dtype weight copies are made once
(:func:`cast_for_compute`) and the serving cache is updated in place.

Attention-free: the serving cache is nine per-lane recurrent leaves
(state kind ``"recurrent"``: slotted only, hard-reset at admission, zeroed
at eviction), O(1) in sequence length.  Under ``attn_impl="kernel"`` every
norm (each block's ``ln`` and ``out_ln``, and ``ln_f``) is one launch of
the RMSNorm kernel; a block ends in its residual add and the next block
begins with its norm, so no norm of this family takes a residual
(``rmsnorm_add`` is not on its path).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from .common import (
    ParamSpec,
    cast_tree,
    cross_entropy_loss,
    dtype_of,
    init_tree,
    norm,
    remat_wrap,
    use,
    use_layer,
)
from .lm import ATTN_IMPLS
from .xlstm import (
    STORED_DTYPE,
    mlstm_block_fwd,
    mlstm_block_specs,
    slstm_block_fwd,
    slstm_block_specs,
    xlstm_dims,
)

# serve-engine state kind: every cache leaf is a per-lane recurrent state
# (nothing to page, nothing to prefix-share)
STATE_KIND = "recurrent"
M_LEAVES = ("m_conv", "m_C", "m_n", "m_m")
S_LEAVES = ("s_conv", "s_h", "s_c", "s_n", "s_m")


def check_supported(cfg: ArchConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not the "
                                  "ssm (xLSTM) family")
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {cfg.attn_impl!r} not in {ATTN_IMPLS}")


def _layout(cfg: ArchConfig) -> tuple[int, int, int]:
    """(n_segments, mlstm_per_segment, n_slstm)."""
    k = cfg.slstm_every
    if not k or cfg.n_layers % k:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} must be a multiple "
                         f"of slstm_every {k}")
    segs = cfg.n_layers // k
    return segs, k - 1, segs


def param_specs(cfg: ArchConfig) -> dict:
    check_supported(cfg)
    segs, per, n_s = _layout(cfg)
    D = cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    return {
        "embed": ParamSpec((cfg.vocab, D), ("tp", "fsdp"), dt),
        "ln_f": ParamSpec((D,), (None,), dt, init_scale=0.0),
        "unembed": ParamSpec((D, cfg.vocab), ("fsdp", "tp"), dt),
        "mlstm": mlstm_block_specs(cfg, segs * per),
        "slstm": slstm_block_specs(cfg, n_s),
    }


def init(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Parameters from a seeded ``torch.Generator`` on ``device`` (the
    reference's shapes and scales, not its random bits)."""
    return init_tree(seed, param_specs(cfg), device)


def cast_for_compute(cfg: ArchConfig, params: dict, device=None) -> dict:
    """The tree the serving path reads: matmul, conv and embedding weights
    in the compute dtype (made once here); norm scales and the sLSTM
    recurrent weights as stored."""
    check_supported(cfg)
    return cast_tree(params, dtype_of(cfg.compute_dtype), STORED_DTYPE, device)


def _embed(cfg, params, tokens):
    return F.embedding(tokens.long(), use(cfg, params, "embed"))


def _unembed(cfg, params, x):
    return x @ use(cfg, params, "unembed")


def _blocks(cfg):
    """The layer walk: ``("m", i)`` for the i-th mLSTM block, ``("s", j)``
    for the j-th sLSTM block, in model order."""
    segs, per, _ = _layout(cfg)
    for si in range(segs):
        for i in range(si * per, (si + 1) * per):
            yield "m", i
        yield "s", si


def _layer(tree, i):
    return {name: p[i] for name, p in tree.items()}


def forward(cfg: ArchConfig, params, tokens, *, remat=False, collect: bool = False,
            plen: int | None = None):
    """tokens (B, T) -> (final-normed hidden (B, T, D), cache dict or None).
    With ``collect=True`` the second element is the nine recurrent leaves
    of :func:`make_cache_specs` at the end of ``tokens``.  ``remat``
    (``common.remat_wrap``) wraps each mLSTM block, as the reference's scan
    body.

    ``plen``: tokens at positions ``>= plen`` are right-padding of a
    length bucket.  Hidden states at positions ``< plen`` are untouched
    (the recurrence is causal); the collected states snapshot position
    ``plen`` (each block treats padded steps as a cell identity and takes
    its conv state at ``plen``).  The serving prefill does not need it
    (:func:`prefill_slot` runs the prompt's own length)."""
    check_supported(cfg)
    x = _embed(cfg, params, tokens)
    valid = None
    if plen is not None:
        valid = (torch.arange(tokens.shape[1], device=x.device) < plen)[None, :]
        x = torch.where(valid[..., None], x, 0.0)          # pad activations stay finite

    def mbody(x, bp):
        # inside the remat: the recompute gathers the layer's shards again
        bp = use_layer(cfg, bp, ("mlstm",))
        return mlstm_block_fwd(cfg, x, bp, valid=valid, state_len=plen)

    mbody = remat_wrap(mbody, remat)
    states = {"m": [], "s": []}
    for kind, i in _blocks(cfg):
        if kind == "m":
            x, st = mbody(x, _layer(params["mlstm"], i))
        else:
            x, st = slstm_block_fwd(cfg, x, use_layer(cfg, _layer(params["slstm"], i),
                                                      ("slstm",)),
                                    valid=valid, state_len=plen)
        if collect:
            states[kind].append(st)
    x = norm(cfg, x, params["ln_f"])
    if not collect:
        return x, None
    m, s = states["m"], states["s"]
    cache = {"m_conv": torch.stack([st[0] for st in m])}
    cache.update({name: torch.stack([st[1][j] for st in m])
                  for j, name in enumerate(M_LEAVES[1:])})
    cache["s_conv"] = torch.stack([st[0] for st in s])
    cache.update({name: torch.stack([st[1][j] for st in s])
                  for j, name in enumerate(S_LEAVES[1:])})
    return x, cache


def loss_fn(cfg: ArchConfig, params, batch, *, remat=True):
    """Next-token loss on ``batch["tokens"]`` (B, S + 1).  Returns
    ``(loss, {"ce_loss", "lb_loss", "drop_frac"})`` (the last two 0)."""
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    hidden, _ = forward(cfg, params, inp, remat=remat)
    loss = cross_entropy_loss(_unembed(cfg, params, hidden), labels)
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss, {"ce_loss": loss, "lb_loss": zero, "drop_frac": zero}


# ---------------------------------------------------------------------------
# Serving (cache = recurrent states; no KV)
# ---------------------------------------------------------------------------


def recurrent_leaf_axes(cfg: ArchConfig) -> dict:
    """Every cache leaf is per-lane recurrent state, lane axis 1 (after the
    layer axis)."""
    return {name: 1 for name in M_LEAVES + S_LEAVES}


def lane_leaf_axes(cfg: ArchConfig) -> dict:
    """All slot-cache leaves a lane owns (the host tier's spill unit): for a
    pure recurrence exactly the recurrent leaves."""
    return recurrent_leaf_axes(cfg)


def make_cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """The nine recurrent leaves as meta tensors (``max_len`` is irrelevant:
    the state is O(1) in sequence length).  Conv states in the compute
    dtype, cell states fp32."""
    segs, per, n_s = _layout(cfg)
    d_inner, dh_m, dh_s = xlstm_dims(cfg)
    H, nm = cfg.n_heads, segs * per
    cdt = dtype_of(cfg.compute_dtype)

    def spec(shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device="meta")

    s = spec((n_s, batch, H, dh_s))
    return {"m_conv": spec((nm, batch, 3, d_inner), cdt),
            "m_C": spec((nm, batch, H, dh_m, dh_m)),
            "m_n": spec((nm, batch, H, dh_m)),
            "m_m": spec((nm, batch, H)),
            "s_conv": spec((n_s, batch, 3, cfg.d_model), cdt),
            "s_h": s, "s_c": s, "s_n": s, "s_m": s}


def prefill(cfg: ArchConfig, params, tokens, *, max_len: int | None = None):
    """tokens (B, S) -> (the recurrent cache at the end of ``tokens``,
    logits (B, V) at the last position)."""
    hidden, cache = forward(cfg, params, tokens, collect=True)
    return cache, _unembed(cfg, params, hidden[:, -1])


def decode_step(cfg: ArchConfig, params, cache, tokens, cur_index):
    """tokens: (B,) int32; ``cur_index`` is unused (the state carries the
    position).  Returns (logits (B, V), cache): every leaf updated in place,
    each layer through its views ``cache[leaf][i]``."""
    check_supported(cfg)
    x = _embed(cfg, params, tokens[:, None])
    for kind, i in _blocks(cfg):
        if kind == "m":
            x, _ = mlstm_block_fwd(
                cfg, x, _layer(params["mlstm"], i), conv_state=cache["m_conv"][i],
                cell_state=tuple(cache[n][i] for n in M_LEAVES[1:]), decode=True)
        else:
            x, _ = slstm_block_fwd(
                cfg, x, _layer(params["slstm"], i), conv_state=cache["s_conv"][i],
                cell_state=tuple(cache[n][i] for n in S_LEAVES[1:]), decode=True)
    x = norm(cfg, x[:, 0], params["ln_f"])
    return _unembed(cfg, params, x), cache


def prefill_slot(cfg: ArchConfig, params, cache, tokens, slot: int, plen: int):
    """Prefill ONE prompt into lane ``slot`` of the slotted recurrent cache.

    tokens: (1, S_bucket), the prompt right-padded to its length bucket.
    The forward runs the prompt's own ``plen`` positions: a recurrent lane
    keeps no per-position state, so the bucket's padding has nothing to
    fill, and the lane's written state is the exact-length prefill's bit
    for bit on any device (the same products at the same shapes; the
    reference reaches its snapshot through identity steps over the
    padding instead, ``forward(plen=)``).  Returns (cache, logits (1, V)
    at position plen - 1), the cache in place."""
    hidden, new = forward(cfg, params, tokens[:, :plen], collect=True)
    for name, leaf in new.items():
        cache[name][:, slot] = leaf[:, 0].to(cache[name].dtype)
    return cache, _unembed(cfg, params, hidden[:, plen - 1])
