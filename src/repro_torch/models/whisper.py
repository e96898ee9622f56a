"""Whisper-style encoder-decoder [arXiv:2212.04356].

The port of the reference's ``models/whisper.py``.  The conv frontend is a
stub, as in the reference: inputs are precomputed frame embeddings (B,
enc_seq, d_model) standing in for the 2x conv1d features.  Encoder:
bidirectional attention and sinusoidal positions.  Decoder: causal
self-attention with RoPE (the reference's adaptation of Whisper's learned
positions), cross-attention over the encoder output, GELU MLP.  The
embedding table, padded to a multiple of 256 rows, is tied with the output
head.

Under ``attn_impl="kernel"`` every prefill attention is one launch of the
flash kernel: the encoder's self-attention and the prefill's
cross-attention non-causal (``causal=False``), the decoder's prefill
self-attention causal; each norm is one launch of the RMSNorm kernels,
the residual add before ``ln2`` (encoder), ``lnx`` and ``ln2`` (decoder)
folded into ``rmsnorm_add`` (``common.norm_add``).  The single-token decode
attention and the cross-attention decode (:func:`_cross_decode`) stay
plain, as in the reference.  Serving is the static loop's
(``serve.loop.generate_static``): the family feeds per-request frames the
slot engine does not carry.  Caches are updated in place, as in ``lm.py``.
"""
from __future__ import annotations

import math

import numpy as np
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

NORM_PARAMS = frozenset({"ln1", "ln2", "lnx", "enc_ln_f", "ln_f"})


def check_supported(cfg: ArchConfig) -> None:
    if cfg.family != "audio":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not the "
                                  "audio (whisper) family")
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {cfg.attn_impl!r} not in {ATTN_IMPLS}")


def _attn_specs(cfg, L, ll, dt, prefix=""):
    D, dh, H, Hk = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv
    return {
        prefix + "wq": ParamSpec(L + (D, H * dh), ll + ("fsdp", "tp"), dt),
        prefix + "wk": ParamSpec(L + (D, Hk * dh), ll + ("fsdp", "tp"), dt),
        prefix + "wv": ParamSpec(L + (D, Hk * dh), ll + ("fsdp", "tp"), dt),
        prefix + "wo": ParamSpec(L + (H * dh, D), ll + ("tp", "fsdp"), dt),
    }


def _mlp_specs(cfg, L, ll, dt):
    return {"w1": ParamSpec(L + (cfg.d_model, cfg.d_ff), ll + ("fsdp", "tp"), dt),
            "w2": ParamSpec(L + (cfg.d_ff, cfg.d_model), ll + ("tp", "fsdp"), dt)}


def padded_vocab(cfg: ArchConfig) -> int:
    """Whisper's 51,865-token vocab padded to a multiple of 256 (the
    reference's tp-shardable table).  Labels never reference the padding,
    so the loss over the extended vocab is exact."""
    return int(math.ceil(cfg.vocab / 256) * 256)


def param_specs(cfg: ArchConfig) -> dict:
    check_supported(cfg)
    dt = dtype_of(cfg.param_dtype)
    D = cfg.d_model
    Le, Ld = (cfg.enc_layers,), (cfg.n_layers,)
    ll = (None,)
    enc = {
        "ln1": ParamSpec(Le + (D,), ll + (None,), dt, init_scale=0.0),
        "ln2": ParamSpec(Le + (D,), ll + (None,), dt, init_scale=0.0),
        **_attn_specs(cfg, Le, ll, dt),
        **_mlp_specs(cfg, Le, ll, dt),
    }
    dec = {
        "ln1": ParamSpec(Ld + (D,), ll + (None,), dt, init_scale=0.0),
        "lnx": ParamSpec(Ld + (D,), ll + (None,), dt, init_scale=0.0),
        "ln2": ParamSpec(Ld + (D,), ll + (None,), dt, init_scale=0.0),
        **_attn_specs(cfg, Ld, ll, dt),
        **_attn_specs(cfg, Ld, ll, dt, prefix="x_"),
        **_mlp_specs(cfg, Ld, ll, dt),
    }
    return {
        "embed": ParamSpec((padded_vocab(cfg), D), ("tp", "fsdp"), dt),
        "enc": enc,
        "dec": dec,
        "enc_ln_f": ParamSpec((D,), (None,), dt, init_scale=0.0),
        "ln_f": ParamSpec((D,), (None,), dt, init_scale=0.0),
    }


def init(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Parameters from a seeded ``torch.Generator`` on ``device`` (the
    reference's shapes and scales, not its random bits)."""
    return init_tree(seed, param_specs(cfg), device)


def cast_for_compute(cfg: ArchConfig, params: dict, device=None) -> dict:
    """The tree the serving path reads: matmul and embedding weights in the
    compute dtype (made once here), norm scales as stored."""
    check_supported(cfg)
    return cast_tree(params, dtype_of(cfg.compute_dtype), NORM_PARAMS, device)


def _w(bp, name, cfg):
    return bp[name].to(dtype_of(cfg.compute_dtype))


def _layer(tree, i):
    return {name: p[i] for name, p in tree.items()}


def _sinusoid(T: int, D: int, dtype, device):
    """Sinusoidal positions (T, D), computed in float64 and rounded to
    ``dtype`` once, as the reference."""
    pos = np.arange(T)[:, None]
    dim = np.arange(D // 2)[None, :]
    ang = pos / (10_000 ** (2 * dim / D))
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.tensor(emb, dtype=torch.float64, device=device).to(dtype)


def _attend(cfg, q, k, v, causal: bool):
    """Prefill attention: the flash kernel's wrapper under
    ``attn_impl="kernel"``, else ``chunked_attention`` (chunks of at most
    256, as the reference)."""
    if cfg.attn_impl == "kernel":
        from repro_torch.kernels.flash_attention.ops import flash_attention
        return flash_attention(q, k, v, causal=causal)
    return chunked_attention(q, k, v, causal=causal, q_chunk=min(256, q.shape[1]),
                             kv_chunk=min(256, k.shape[1]))


def _mha(cfg, bp, prefix, xq, xkv, *, causal, rope_cs=None):
    """Full attention between xq (B,Sq,D) and xkv (B,Sk,D); ``rope_cs``
    (the decoder's self-attention, Sq == Sk) rotates q and k.  Returns
    (output (B,Sq,D), (k, v))."""
    B, Sq, _ = xq.shape
    Sk = xkv.shape[1]
    dh, H, Hk = cfg.head_dim, cfg.n_heads, cfg.n_kv
    q = (xq @ _w(bp, prefix + "wq", cfg)).reshape(B, Sq, H, dh)
    k = (xkv @ _w(bp, prefix + "wk", cfg)).reshape(B, Sk, Hk, dh)
    v = (xkv @ _w(bp, prefix + "wv", cfg)).reshape(B, Sk, Hk, dh)
    if rope_cs is not None:
        q, k = apply_rope(q, *rope_cs), apply_rope(k, *rope_cs)
    out = _attend(cfg, q, k, v, causal)
    return out.reshape(B, Sq, -1) @ _w(bp, prefix + "wo", cfg), (k, v)


def _mlp(cfg, bp, x):
    h = x @ _w(bp, "w1", cfg)
    return F.gelu(h, approximate="tanh") @ _w(bp, "w2", cfg)


def encode(cfg: ArchConfig, params, frames):
    """frames (B, enc_seq, d_model) -> the encoder output, final-normed."""
    check_supported(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    x = frames.to(cdt) + _sinusoid(frames.shape[1], cfg.d_model, cdt, frames.device)[None]
    for i in range(cfg.enc_layers):
        bp = use_layer(cfg, _layer(params["enc"], i), ("enc",))
        h = norm(cfg, x, bp["ln1"])
        o, _ = _mha(cfg, bp, "", h, h, causal=False)
        h, x = norm_add(cfg, x, o, bp["ln2"])
        x = x + _mlp(cfg, bp, h)
    return norm(cfg, x, params["enc_ln_f"])


def _embed(cfg, params, tokens):
    return F.embedding(tokens.long(), use(cfg, params, "embed"))


def decode_train(cfg: ArchConfig, params, tokens, enc_out, *, remat=False,
                 collect_kv: bool = False):
    """The decoder over whole sequences: tokens (B, S) against ``enc_out``.
    Returns (final-normed hidden, ((k, v), (xk, xv)) stacked over layers,
    each (L, B, S or enc_seq, Hk, dh), or None)."""
    x = _embed(cfg, params, tokens)
    B, S = tokens.shape
    pos = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    rope_cs = rope_tables(pos, cfg.head_dim, cfg.rope_theta)

    def body(x, bp):
        bp = use_layer(cfg, bp, ("dec",))        # inside the remat, as in lm.py
        h = norm(cfg, x, bp["ln1"])
        o, kv = _mha(cfg, bp, "", h, h, causal=True, rope_cs=rope_cs)
        h, x = norm_add(cfg, x, o, bp["lnx"])
        o, xkv = _mha(cfg, bp, "x_", h, enc_out, causal=False)
        h, x = norm_add(cfg, x, o, bp["ln2"])
        return x + _mlp(cfg, bp, h), kv + xkv

    body = remat_wrap(body, remat)
    kvs = []
    for i in range(cfg.n_layers):
        x, kv = body(x, _layer(params["dec"], i))
        if collect_kv:
            kvs.append(kv)
    x = norm(cfg, x, params["ln_f"])
    if not collect_kv:
        return x, None
    k, v, xk, xv = (torch.stack([kv[j] for kv in kvs]) for j in range(4))
    return x, ((k, v), (xk, xv))


def _logits(cfg, params, x):
    """Tied head over the padded vocab."""
    return x @ use(cfg, params, "embed").t()


def loss_fn(cfg: ArchConfig, params, batch, *, remat=True):
    """Next-token loss on ``batch["tokens"]`` (B, S + 1) given
    ``batch["frames"]``.  Returns ``(loss, {"ce_loss", "lb_loss",
    "drop_frac"})`` (the last two 0)."""
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    enc_out = encode(cfg, params, batch["frames"])
    hidden, _ = decode_train(cfg, params, inp, enc_out, remat=remat)
    loss = cross_entropy_loss(_logits(cfg, params, hidden), labels)
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss, {"ce_loss": loss, "lb_loss": zero, "drop_frac": zero}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def make_cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """Self-attention KV ``k``/``v`` (L, B, max_len, Hk, dh) and the
    encoder's cross-attention KV ``xk``/``xv`` (L, B, enc_seq, Hk, dh), as
    meta tensors in the compute dtype."""
    cdt = dtype_of(cfg.compute_dtype)
    L, Hk, dh = cfg.n_layers, cfg.n_kv, cfg.head_dim
    kv = torch.empty((L, batch, max_len, Hk, dh), dtype=cdt, device="meta")
    xkv = torch.empty((L, batch, cfg.enc_seq, Hk, dh), dtype=cdt, device="meta")
    return {"k": kv, "v": kv, "xk": xkv, "xv": xkv}


def prefill(cfg: ArchConfig, params, tokens, frames=None, *, max_len: int | None = None):
    """tokens (B, S), frames (B, enc_seq, d_model) -> (cache: ``k``/``v``
    padded to ``max_len`` on the position axis, ``xk``/``xv``; logits (B,
    padded vocab) at the last position)."""
    enc_out = encode(cfg, params, frames)
    hidden, ((k, v), (xk, xv)) = decode_train(cfg, params, tokens, enc_out, collect_kv=True)
    pad = [0, 0, 0, 0, 0, max(0, (max_len or 0) - k.shape[2])]
    cache = {"k": F.pad(k, pad), "v": F.pad(v, pad), "xk": xk, "xv": xv}
    return cache, _logits(cfg, params, hidden[:, -1])


def _cross_decode(cfg, bp, x, xk, xv):
    """Single-token cross-attention over the cached encoder K/V (plain
    fp32 softmax, as the reference).  x (B, D); xk/xv (B, enc_seq, Hk,
    dh)."""
    B = x.shape[0]
    dh, H, Hk = cfg.head_dim, cfg.n_heads, cfg.n_kv
    q = (x @ _w(bp, "x_wq", cfg)).reshape(B, Hk, H // Hk, dh)
    s = torch.einsum("bhrd,bshd->bhrs", q.float(), xk.float()) * (dh ** -0.5)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhrs,bshd->bhrd", p, xv.float()).to(x.dtype)
    return o.reshape(B, H * dh) @ _w(bp, "x_wo", cfg)


def decode_step(cfg: ArchConfig, params, cache, tokens, cur_index):
    """tokens: (B,) int32; cur_index: tokens already in the cache, a scalar
    or a (B,) vector.  Returns (logits (B, padded vocab), cache), ``k``/``v``
    written in place."""
    check_supported(cfg)
    x = _embed(cfg, params, tokens)
    B = x.shape[0]
    dh, H, Hk = cfg.head_dim, cfg.n_heads, cfg.n_kv
    rope_cs = rope_tables(decode_positions(cur_index, B, x.device), dh, cfg.rope_theta)
    for i in range(cfg.n_layers):
        bp = _layer(params["dec"], i)
        h = norm(cfg, x, bp["ln1"])
        q = (h @ _w(bp, "wq", cfg)).reshape(B, H, dh)
        k = (h @ _w(bp, "wk", cfg)).reshape(B, Hk, dh)
        v = (h @ _w(bp, "wv", cfg)).reshape(B, Hk, dh)
        q = apply_rope(q[:, None], *rope_cs)[:, 0].reshape(B, Hk, H // Hk, dh)
        k = apply_rope(k[:, None], *rope_cs)[:, 0]
        attn = decode_attention(q, cache["k"][i], cache["v"][i], k, v, cur_index)
        h, x = norm_add(cfg, x, attn.reshape(B, H * dh) @ _w(bp, "wo", cfg), bp["lnx"])
        h, x = norm_add(cfg, x, _cross_decode(cfg, bp, h, cache["xk"][i], cache["xv"][i]),
                        bp["ln2"])
        x = x + _mlp(cfg, bp, h)
    x = norm(cfg, x, params["ln_f"])
    return _logits(cfg, params, x), cache
