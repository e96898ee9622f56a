"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory, sequential scan with recurrent mixing).

The port of the reference's ``models/xlstm.py``.  The mLSTM recurrence (per
head; C: (dk, dv) matrix memory):

    m_t = max(logf_t + m_{t-1}, logi_t)
    C_t = exp(logf_t + m_{t-1} - m_t) C_{t-1} + exp(logi_t - m_t) k_t v_t^T
    n_t = exp(logf_t + m_{t-1} - m_t) n_{t-1} + exp(logi_t - m_t) k_t
    h_t = C_t^T q_t / max(|n_t . q_t|, exp(-m_t))

is evaluated chunkwise (:func:`mlstm_chunked`): intra-chunk terms as
(Q x Q) masked matmuls, the inter-chunk state carried as (C*, n*, m*) with
the stabiliser folded in.  The cells are plain PyTorch, as they are plain
jnp in the reference (no Pallas kernel computes them); the block's norms go
through :func:`~repro_torch.models.common.norm` (the RMSNorm kernel under
``attn_impl="kernel"``).  The mLSTM out-norm is ``norm(y) * silu(z)``: the
norm first and then the gate, an eager product after the kernel (not the
gated kernel entry, which gates first).

The log-decay is ``-softplus(-f)``, the reference's ``log_sigmoid``: a
padded step's ``f_pre = 1e30`` gives ``-0.0`` (``F.logsigmoid`` gives
``+0.0``), so the log-decay cumsum passes it bit-unchanged, as the
reference's does.

Decode (``decode=True``) writes the conv state and the cell state IN PLACE
into the tensors it is given (a layer's views of the stacked cache), so a
CUDA graph captured on the cache stays valid.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from .common import ParamSpec, dtype_of, norm
from .ssm import _causal_conv

NEG_BIG = -1e30        # the stabiliser's start and the "no input" gate


def _log_sigmoid(x):
    """``log(sigmoid(x))`` as the reference computes it, ``-softplus(-x)``
    (so ``x = 1e30`` gives ``-0.0``)."""
    return -F.softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM cell
# ---------------------------------------------------------------------------


def mlstm_chunked(q, k, v, i_pre, f_pre, *, chunk: int, return_state: bool = False):
    """q/k/v: (B,T,H,Dh); i_pre/f_pre: (B,T,H).  Returns (B,T,H,Dh) in
    q's dtype (and the final fp32 (C, n, m) cell state if requested)."""
    B, T, H, Dh = q.shape
    Q = min(chunk, T)
    T_real = T
    if T % Q:
        # identity padding: f -> 1 (f_pre large +), i -> 0 (i_pre large -)
        pad = Q - T % Q

        def zpad(a, val=0.0):
            return F.pad(a, [0, 0] * (a.dim() - 2) + [0, pad], value=val)

        q, k, v = zpad(q), zpad(k), zpad(v)
        i_pre, f_pre = zpad(i_pre, NEG_BIG), zpad(f_pre, 30.0)
        T = T + pad
    nc = T // Q

    qf = q.float() * (Dh ** -0.5)
    logf = _log_sigmoid(f_pre.float())                     # (B,T,H)
    logi = i_pre.float()

    def chunks(a):                                         # -> (nc,B,H,Q,Dh)
        return a.reshape(B, nc, Q, H, Dh).permute(1, 0, 3, 2, 4)

    qc, kc, vc = chunks(qf), chunks(k.float()), chunks(v.float())
    lfc = logf.reshape(B, nc, Q, H).permute(1, 0, 3, 2)    # (nc,B,H,Q)
    lic = logi.reshape(B, nc, Q, H).permute(1, 0, 3, 2)
    above = torch.ones(Q, Q, dtype=torch.bool, device=q.device).triu(1)

    Cs = torch.zeros(B, H, Dh, Dh, dtype=torch.float32, device=q.device)
    ns = torch.zeros(B, H, Dh, dtype=torch.float32, device=q.device)
    ms = torch.full((B, H), NEG_BIG, dtype=torch.float32, device=q.device)
    hs = []
    for c in range(nc):
        qi, ki, vi, lf, li = qc[c], kc[c], vc[c], lfc[c], lic[c]
        b = torch.cumsum(lf, dim=-1)                       # (B,H,Q) inclusive
        g = li - b
        gmax = torch.cummax(g, dim=-1).values
        M = b + torch.maximum(ms[..., None], gmax)         # (B,H,Q) row stabiliser

        # intra: w[t,s] = exp(b_t - b_s + li_s - M_t), s <= t.  Above the
        # diagonal the exponent may overflow: it is set to -inf before the
        # exp, so w is 0 there and the backward never multiplies a zero
        # gradient by inf
        e = b[..., :, None] - b[..., None, :] + li[..., None, :] - M[..., :, None]
        w = torch.exp(e.masked_fill(above, float("-inf")))
        scores = (qi @ ki.transpose(-1, -2)) * w
        num = scores @ vi
        den = scores.sum(dim=-1)

        # inter: stored state scaled by exp(ms); contribution exp(ms + b_t - M_t)
        qs = qi * torch.exp(ms[..., None] + b - M)[..., None]
        num = num + qs @ Cs
        den = den + (qs @ ns[..., None])[..., 0]
        hs.append(num / torch.maximum(den.abs(), torch.exp(-M))[..., None])

        # end-of-chunk state
        btot = b[..., -1]                                  # (B,H)
        m_new = btot + torch.maximum(ms, g.amax(dim=-1))
        wst = torch.exp(btot[..., None] - b + li - m_new[..., None])   # (B,H,Q)
        decay = torch.exp(ms + btot - m_new)
        Cs = Cs * decay[..., None, None] + (ki * wst[..., None]).transpose(-1, -2) @ vi
        ns = ns * decay[..., None] + (ki.transpose(-1, -2) @ wst[..., None])[..., 0]
        ms = m_new
    y = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(B, T, H, Dh)[:, :T_real].to(q.dtype)
    if return_state:
        return y, (Cs, ns, ms)
    return y


def mlstm_reference(q, k, v, i_pre, f_pre):
    """Per-step recurrence oracle (tests)."""
    B, T, H, Dh = q.shape
    qf = q.float() * (Dh ** -0.5)
    kf, vf = k.float(), v.float()
    logf = _log_sigmoid(f_pre.float())
    logi = i_pre.float()
    C = torch.zeros(B, H, Dh, Dh, dtype=torch.float32, device=q.device)
    n = torch.zeros(B, H, Dh, dtype=torch.float32, device=q.device)
    m = torch.full((B, H), NEG_BIG, dtype=torch.float32, device=q.device)
    hs = []
    for t in range(T):
        qt, kt, vt, lf, li = qf[:, t], kf[:, t], vf[:, t], logf[:, t], logi[:, t]
        m_new = torch.maximum(lf + m, li)
        fs = torch.exp(lf + m - m_new)
        is_ = torch.exp(li - m_new)
        C = C * fs[..., None, None] + is_[..., None, None] * (kt[..., :, None] * vt[..., None, :])
        n = n * fs[..., None] + is_[..., None] * kt
        m = m_new
        num = torch.einsum("bhd,bhde->bhe", qt, C)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", qt, n).abs(), torch.exp(-m))
        hs.append(num / den[..., None])
    return torch.stack(hs, dim=1).to(q.dtype)


def mlstm_decode_step(state, qt, kt, vt, i_pre, f_pre):
    """state: (C (B,H,Dh,Dh), n (B,H,Dh), m (B,H)) fp32, updated IN PLACE
    (the decode path's cache views); one token step.  Returns (state, h
    (B,H,Dh) in qt's dtype).  C is scaled and then takes the outer product,
    two passes, with ``exp(logi - m)`` folded into k first: an fp32
    rounding apart from the reference's ``is * (k v^T)``."""
    C, n, m = state
    Dh = qt.shape[-1]
    qf = qt.float() * (Dh ** -0.5)
    kf, vf = kt.float(), vt.float()
    lf = _log_sigmoid(f_pre.float())
    li = i_pre.float()
    m_new = torch.maximum(lf + m, li)
    fs = torch.exp(lf + m - m_new)
    is_ = torch.exp(li - m_new)
    C.mul_(fs[..., None, None]).addcmul_((is_[..., None] * kf)[..., :, None], vf[..., None, :])
    n.mul_(fs[..., None]).add_(is_[..., None] * kf)
    m.copy_(m_new)
    num = (qf[..., None, :] @ C)[..., 0, :]
    den = torch.maximum((qf * n).sum(dim=-1).abs(), torch.exp(-m_new))
    return state, (num / den[..., None]).to(qt.dtype)


# ---------------------------------------------------------------------------
# sLSTM cell (sequential scan; block-diagonal recurrent mixing)
# ---------------------------------------------------------------------------


def slstm_scan(x_z, x_i, x_f, x_o, r_z, r_i, r_f, r_o, h0, c0, n0, m0, valid=None):
    """x_*: (B,T,H,Dh) pre-activations from the input path; r_*: (H,Dh,Dh)
    recurrent (block-diagonal head mixing) weights.  Returns (h (B,T,H,Dh)
    fp32, final (h, c, n, m)).

    ``valid`` ((B,T) or (1,T) bool): steps where it is False leave the
    carried state untouched (a select keeps the old carry bitwise), so a
    right-padded bucket carries out the state at the end of the real
    prompt.  One Python step a position; the four recurrent products are
    one batched product a step (the r_* side by side)."""
    Dh = x_z.shape[-1]
    R = torch.cat([r_z, r_i, r_f, r_o], dim=-1).float()           # (H, Dh, 4 Dh)
    xz, xi, xf, xo = (a.float() for a in (x_z, x_i, x_f, x_o))
    h, c, n, m = h0, c0, n0, m0
    hs = []
    for t in range(x_z.shape[1]):
        hr = torch.bmm(h.transpose(0, 1), R).transpose(0, 1)      # (B, H, 4 Dh)
        rz, ri, rf, ro = hr.split(Dh, dim=-1)
        zt = torch.tanh(xz[:, t] + rz)
        it = xi[:, t] + ri
        ft = xf[:, t] + rf
        ot = torch.sigmoid(xo[:, t] + ro)
        m_new = torch.maximum(ft + m, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(ft + m - m_new)
        c_new = f_s * c + i_s * zt
        n_new = f_s * n + i_s
        h_new = ot * c_new / torch.clamp(n_new, min=1e-6)
        if valid is not None:
            keep = valid[:, t, None, None]
            h_new = torch.where(keep, h_new, h)
            c_new = torch.where(keep, c_new, c)
            n_new = torch.where(keep, n_new, n)
            m_new = torch.where(keep, m_new, m)
        h, c, n, m = h_new, c_new, n_new, m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c, n, m)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def xlstm_dims(cfg: ArchConfig):
    d_inner = 2 * cfg.d_model          # mLSTM projection factor 2
    dh_m = d_inner // cfg.n_heads
    dh_s = cfg.d_model // cfg.n_heads
    return d_inner, dh_m, dh_s


def slstm_ffn_width(cfg: ArchConfig) -> int:
    """The sLSTM block's 4/3 GLU width, rounded up to a multiple of 64."""
    return max(int(math.ceil(4 * cfg.d_model / 3 / 64) * 64), 64)


def mlstm_block_specs(cfg: ArchConfig, n: int) -> dict:
    D = cfg.d_model
    d_inner, _, _ = xlstm_dims(cfg)
    H = cfg.n_heads
    L, ll = (n,), (None,)
    dt = dtype_of(cfg.param_dtype)
    return {
        "ln": ParamSpec(L + (D,), ll + (None,), dt, init_scale=0.0),
        "w_up": ParamSpec(L + (D, 2 * d_inner), ll + ("fsdp", "tp"), dt),
        "conv_w": ParamSpec(L + (4, d_inner), ll + (None, "tp"), dt),
        "conv_b": ParamSpec(L + (d_inner,), ll + ("tp",), dt, init_scale=0.0),
        "wq": ParamSpec(L + (d_inner, d_inner), ll + ("fsdp", "tp"), dt),
        "wk": ParamSpec(L + (d_inner, d_inner), ll + ("fsdp", "tp"), dt),
        "wv": ParamSpec(L + (d_inner, d_inner), ll + ("fsdp", "tp"), dt),
        "w_gates": ParamSpec(L + (d_inner, 2 * H), ll + ("fsdp", None), dt),
        "b_gates": ParamSpec(L + (2 * H,), ll + (None,), dt, init_scale=0.0),
        "out_ln": ParamSpec(L + (d_inner,), ll + (None,), dt, init_scale=0.0),
        "w_down": ParamSpec(L + (d_inner, D), ll + ("tp", "fsdp"), dt),
    }


def slstm_block_specs(cfg: ArchConfig, n: int) -> dict:
    D = cfg.d_model
    H = cfg.n_heads
    dh = D // H
    f = slstm_ffn_width(cfg)
    L, ll = (n,), (None,)
    dt = dtype_of(cfg.param_dtype)
    return {
        "ln": ParamSpec(L + (D,), ll + (None,), dt, init_scale=0.0),
        "conv_w": ParamSpec(L + (4, D), ll + (None, None), dt),
        "conv_b": ParamSpec(L + (D,), ll + (None,), dt, init_scale=0.0),
        "w_in": ParamSpec(L + (D, 4 * D), ll + ("fsdp", "tp"), dt),
        "b_in": ParamSpec(L + (4 * D,), ll + (None,), dt, init_scale=0.0),
        "r_z": ParamSpec(L + (H, dh, dh), ll + (None, None, None), dt),
        "r_i": ParamSpec(L + (H, dh, dh), ll + (None, None, None), dt),
        "r_f": ParamSpec(L + (H, dh, dh), ll + (None, None, None), dt),
        "r_o": ParamSpec(L + (H, dh, dh), ll + (None, None, None), dt),
        "out_ln": ParamSpec(L + (D,), ll + (None,), dt, init_scale=0.0),
        "w_up1": ParamSpec(L + (D, f), ll + ("fsdp", "tp"), dt),
        "w_up2": ParamSpec(L + (D, f), ll + ("fsdp", "tp"), dt),
        "w_down": ParamSpec(L + (f, D), ll + ("tp", "fsdp"), dt),
    }


# leaves read in their stored dtype: the norm scales and the sLSTM
# recurrent weights (read in fp32, as the reference's ``.astype(float32)``)
STORED_DTYPE = frozenset({"ln", "out_ln", "ln_f", "r_z", "r_i", "r_f", "r_o"})


def _w(bp, name, cfg):
    return bp[name].to(dtype_of(cfg.compute_dtype))


def _conv(cfg, x, bp, conv_state, state_len, decode: bool):
    """The block's causal conv; on decode the new conv state is written
    into ``conv_state`` in place."""
    y, new = _causal_conv(x, _w(bp, "conv_w", cfg), _w(bp, "conv_b", cfg),
                          conv_state, state_len=state_len)
    if decode:
        conv_state.copy_(new)
        new = conv_state
    return F.silu(y), new


def mlstm_block_fwd(cfg: ArchConfig, x, bp, *, chunk: int = 128, conv_state=None,
                    cell_state=None, decode: bool = False, valid=None, state_len=None):
    """x: (B,T,D) (T = 1 with states for decode).  Returns (x', (conv_state,
    (C, n, m))).

    ``valid`` ((B,T) or (1,T) bool) marks the real positions of a
    right-padded prompt bucket.  Padded steps are forced to a cell
    identity: ``i_pre -> -1e30`` (input weight ``exp(-1e30 - m) == 0``)
    and ``f_pre -> 1e30`` (log-decay ``-0.0``: the cumsum is
    bit-unchanged).  ``state_len`` snapshots the conv state at that
    position.  ``decode=True`` updates ``conv_state`` and ``cell_state``
    in place."""
    d_inner, dh, _ = xlstm_dims(cfg)
    H = cfg.n_heads
    B, T = x.shape[:2]
    h = norm(cfg, x, bp["ln"])
    a, z = (h @ _w(bp, "w_up", cfg)).chunk(2, dim=-1)
    c, conv_state = _conv(cfg, a, bp, conv_state, state_len, decode)
    q = (c @ _w(bp, "wq", cfg)).reshape(B, T, H, dh)
    k = (c @ _w(bp, "wk", cfg)).reshape(B, T, H, dh)
    v = (a @ _w(bp, "wv", cfg)).reshape(B, T, H, dh)
    gates = a @ _w(bp, "w_gates", cfg) + _w(bp, "b_gates", cfg)
    i_pre, f_pre = gates.chunk(2, dim=-1)                  # (B,T,H)
    if valid is not None:
        i_pre = torch.where(valid[..., None], i_pre, NEG_BIG)
        f_pre = torch.where(valid[..., None], f_pre, 1e30)
    if decode:
        cell_state, y = mlstm_decode_step(cell_state, q[:, 0], k[:, 0], v[:, 0],
                                          i_pre[:, 0], f_pre[:, 0])
        y = y[:, None]
    else:
        y, cell_state = mlstm_chunked(q, k, v, i_pre, f_pre, chunk=chunk, return_state=True)
    y = norm(cfg, y.reshape(B, T, d_inner), bp["out_ln"]) * F.silu(z)
    return x + y @ _w(bp, "w_down", cfg), (conv_state, cell_state)


def slstm_state_init(cfg: ArchConfig, batch: int, device):
    """The sLSTM cell's start: h, c, n zero and m at -1e30, (B,H,Dh) fp32."""
    H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    z = lambda: torch.zeros(batch, H, dh, dtype=torch.float32, device=device)
    return z(), z(), z(), torch.full((batch, H, dh), NEG_BIG, dtype=torch.float32,
                                     device=device)


def slstm_block_fwd(cfg: ArchConfig, x, bp, *, conv_state=None, cell_state=None,
                    decode: bool = False, valid=None, state_len=None):
    """``valid``/``state_len``: see :func:`mlstm_block_fwd`; the sLSTM scan
    freezes its carry on padded steps instead of gate overrides.
    ``decode=True`` writes the conv and cell states in place."""
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    B, T = x.shape[:2]
    h = norm(cfg, x, bp["ln"])
    c, conv_state = _conv(cfg, h, bp, conv_state, state_len, decode)
    pre = c @ _w(bp, "w_in", cfg) + _w(bp, "b_in", cfg)
    xz, xi, xf, xo = (p.reshape(B, T, H, dh) for p in pre.chunk(4, dim=-1))
    state = cell_state if cell_state is not None else slstm_state_init(cfg, B, x.device)
    hs, new = slstm_scan(xz, xi, xf, xo, bp["r_z"], bp["r_i"], bp["r_f"], bp["r_o"],
                         *state, valid=valid)
    if decode:
        for dst, src in zip(cell_state, new):
            dst.copy_(src)
        new = cell_state
    y = norm(cfg, hs.reshape(B, T, D).to(dtype_of(cfg.compute_dtype)), bp["out_ln"])
    g = y @ _w(bp, "w_up1", cfg)
    u = y @ _w(bp, "w_up2", cfg)
    return x + (F.gelu(g, approximate="tanh") * u) @ _w(bp, "w_down", cfg), (conv_state, new)
