"""Mamba2 (SSD) blocks — chunked, matmul-based state-space scan.

The port of the reference's ``models/ssm.py``.  The SSD ("state-space
duality") form computes the selective SSM with chunk-local attention-like
matmuls plus an inter-chunk state recurrence.  :func:`ssd_chunked` is the
plain PyTorch version; with ``cfg.attn_impl == "kernel"`` the Mamba2 block
runs the hand-written CUDA scan instead (``kernels/ssd``), which computes
the same function with the state carried in shared memory.

Shapes follow Mamba2: x (B,T,H,P); dt (B,T,H); A (H,) negative;
B/C (B,T,G,N) with H % G == 0.

Every norm of the block goes through :func:`~repro_torch.models.common.norm`
or, for the out-norm with its skip and gate, :func:`norm_gated`: each picks
its RMSNorm kernel or the plain ``rms_norm`` by ``cfg.attn_impl``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from .common import ParamSpec, dtype_of, norm, rms_norm


def norm_gated(cfg: ArchConfig, y, x, z, d_skip, gamma):
    """The out-norm with its skip and gate: ``rms_norm(((y + D x) in the
    compute dtype) * silu(z))``, y (fp32) and x ``(..., H, P)``, z ``(...,
    H * P)``.  Under ``attn_impl="kernel"`` one launch of the gated RMSNorm
    kernel, which reads x and z (views into the block's projections)
    through their row strides; else the plain path's eager ops, each
    rounding to the compute dtype as the kernel reproduces."""
    if cfg.attn_impl == "kernel":
        from repro_torch.kernels.rmsnorm.ops import rmsnorm_gated
        return rmsnorm_gated(y.flatten(-2), z, gamma, x=x.flatten(-2), d_skip=d_skip,
                             head_dim=y.shape[-1], eps=cfg.norm_eps)
    y = y + d_skip.float()[:, None] * x.float()
    y = y.flatten(-2).to(dtype_of(cfg.compute_dtype))
    return rms_norm(y * F.silu(z), gamma, cfg.norm_eps)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int, return_state: bool = False):
    """Returns y (B,T,H,P) fp32 (and the final SSM state (B,H,N,P) fp32 if
    requested)."""
    Bsz, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, T)
    T_real = T
    if T % Q:
        # pad with dt=0 steps: decay=exp(0)=1 and input weight dt=0, so the
        # padded tail is an identity on the state and the outputs slice off
        pad = Q - T % Q
        zpad = lambda a: F.pad(a, [0, 0] * (a.ndim - 2) + [0, pad])
        x, dt, Bm, Cm = zpad(x), zpad(dt), zpad(Bm), zpad(Cm)
        T = T + pad
    nc = T // Q

    x = x.float()
    dt = dt.float()
    A = A.float()
    Bh = torch.repeat_interleave(Bm.float(), rep, dim=2)     # (B,T,H,N)
    Ch = torch.repeat_interleave(Cm.float(), rep, dim=2)

    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bh.reshape(Bsz, nc, Q, H, N)
    Cc = Ch.reshape(Bsz, nc, Q, H, N)

    la = dtc * A                                # (B,nc,Q,H) log-decay <= 0
    cum = torch.cumsum(la, dim=2)               # inclusive within chunk
    seg_total = cum[:, :, -1]                   # (B,nc,H)

    xdt = xc * dtc[..., None]                   # dt-weighted inputs

    # --- intra-chunk: Y[q] += sum_{k<=q} exp(cum[q]-cum[k]) C_q.B_k x_k ---
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc)
    cum_t = cum.permute(0, 1, 3, 2)             # (B,nc,H,Q)
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    # exp only where k <= q: above the diagonal the exponent is positive
    # and may overflow (inf * 0 is NaN)
    diff = torch.where(mask, cum_t[..., :, None] - cum_t[..., None, :], 0.0)
    scores = torch.where(mask, scores * torch.exp(diff), 0.0)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores, xdt)

    # --- chunk states: S_c = sum_k exp(seg_total - cum[k]) B_k (x_k)^T ---
    w_state = torch.exp(seg_total[:, :, None, :] - cum)      # (B,nc,Q,H)
    states = torch.einsum("bckhn,bckhp->bchnp", Bc * w_state[..., None], xdt)

    # --- inter-chunk recurrence over chunk index ---
    S = torch.zeros(Bsz, H, N, P, dtype=torch.float32, device=x.device)
    S_prev = []
    for c in range(nc):
        S_prev.append(S)                        # state BEFORE chunk c
        S = S * torch.exp(seg_total[:, c])[..., None, None] + states[:, c]
    S_prev = torch.stack(S_prev, dim=1)         # (B,nc,H,N,P)

    # --- inter contribution: Y[q] += exp(cum[q]) C_q . S_prev ---
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", Cc * torch.exp(cum)[..., None], S_prev)
    y = (y_intra + y_inter).reshape(Bsz, T, H, P)[:, :T_real]
    if return_state:
        return y, S
    return y


def ssd_reference(x, dt, A, Bm, Cm):
    """Step-by-step recurrence oracle (tests).  Returns y (B,T,H,P) fp32."""
    Bsz, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Bh = torch.repeat_interleave(Bm.float(), rep, dim=2)
    Ch = torch.repeat_interleave(Cm.float(), rep, dim=2)
    dt = dt.float()
    xf = x.float()
    S = torch.zeros(Bsz, H, N, P, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        decay = torch.exp(dt[:, t] * A)                       # (B,H)
        S = S * decay[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", Bh[:, t], xf[:, t] * dt[:, t, :, None])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], S))
    return torch.stack(ys, dim=1)


def ssd_decode_step(S, x, dt, A, Bm, Cm):
    """One-token state update.  S: (B,H,N,P); x: (B,H,P); dt: (B,H);
    Bm/Cm: (B,G,N).  Returns (S', y (B,H,P))."""
    H = x.shape[1]
    rep = H // Bm.shape[1]
    Bh = torch.repeat_interleave(Bm.float(), rep, dim=1)
    Ch = torch.repeat_interleave(Cm.float(), rep, dim=1)
    decay = torch.exp(dt.float() * A.float())
    S = S * decay[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bh, x.float() * dt[..., None])
    y = torch.einsum("bhn,bhnp->bhp", Ch, S)
    return S, y


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


def mamba_dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.state
    return d_inner, H, conv_ch


def mamba_block_specs(cfg: ArchConfig, n_layers: int) -> dict:
    """Stacked (n_layers, ...) Mamba2 block parameters."""
    D = cfg.d_model
    s = cfg.ssm
    d_inner, H, conv_ch = mamba_dims(cfg)
    L = (n_layers,)
    dt = dtype_of(cfg.param_dtype)
    d_proj = 2 * d_inner + 2 * s.n_groups * s.state + H
    return {
        "ln": ParamSpec(L + (D,), dt, init_scale=0.0),
        "in_proj": ParamSpec(L + (D, d_proj), dt),
        "conv_w": ParamSpec(L + (s.conv_kernel, conv_ch), dt),
        "conv_b": ParamSpec(L + (conv_ch,), dt, init_scale=0.0),
        "dt_bias": ParamSpec(L + (H,), dt, init_scale=0.0),
        "A_log": ParamSpec(L + (H,), dt, init_scale=0.0),
        "D_skip": ParamSpec(L + (H,), dt, init_scale=0.0),
        "out_ln": ParamSpec(L + (d_inner,), dt, init_scale=0.0),
        "out_proj": ParamSpec(L + (d_inner, D), dt),
    }


# leaves the block reads in fp32 (``.astype(float32)`` in the reference) or
# as norm scales: :func:`repro_torch.models.zamba.cast_for_compute` keeps
# them as stored
FP32_PARAMS = frozenset({"ln", "out_ln", "dt_bias", "A_log", "D_skip"})


def _split_proj(cfg: ArchConfig, proj):
    s = cfg.ssm
    d_inner, H, _ = mamba_dims(cfg)
    gn = s.n_groups * s.state
    return torch.split(proj, [d_inner, d_inner, gn, gn, H], dim=-1)


def _causal_conv(x, w, b, state=None, state_len=None):
    """Depthwise causal conv.  x: (B,T,C); w: (K,C); state: (B,K-1,C)|None.

    Returns (y, new_state) — new_state is the last K-1 inputs.  With
    ``state_len`` (1 <= state_len <= T) the state is instead the K-1 inputs
    *preceding position state_len*: the slotted serve engine prefills a
    right-padded length bucket, and the carried conv state must snapshot
    the real prompt end, not the padded tail.
    """
    K = w.shape[0]
    if state is None:
        state = torch.zeros(x.shape[0], K - 1, x.shape[-1], dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    T = x.shape[1]
    y = sum(xp[:, i: i + T] * w[i][None, None, :] for i in range(K)) + b[None, None, :]
    if K <= 1:
        new_state = state
    elif state_len is None:
        new_state = xp[:, -(K - 1):]
    else:
        # xp[state_len : state_len + K - 1] = inputs at positions
        # [state_len - (K-1), state_len): what an exact-length
        # (T == state_len) prefill would have carried
        new_state = xp[:, state_len: state_len + K - 1]
    return y, new_state


def _w(bp, name, cfg):
    return bp[name].to(dtype_of(cfg.compute_dtype))


def _ssd(cfg: ArchConfig, xh, dtv, A, bm, cm):
    """The prefill scan with its final state: the CUDA kernel's wrapper
    under ``attn_impl="kernel"``, else :func:`ssd_chunked`."""
    if cfg.attn_impl == "kernel":
        from repro_torch.kernels.ssd.ops import ssd
        return ssd(xh, dtv, A, bm, cm, chunk=cfg.ssm.chunk)
    return ssd_chunked(xh, dtv, A, bm, cm, chunk=cfg.ssm.chunk, return_state=True)


def mamba_block_fwd(cfg: ArchConfig, x, bp, *, return_state: bool = False,
                    valid=None, state_len=None):
    """x: (B,T,D).  Returns x + mamba(x) (and (ssm, conv) final states).

    ``valid`` ((B,T) or (1,T) bool) marks real positions of a right-padded
    prompt bucket (slotted serve prefill): padded steps get ``dt = 0``,
    an exact identity on the SSD recurrence (decay ``exp(0) = 1``, input
    weight 0), so the carried state is the state at the end of the real
    prompt.  ``state_len`` snapshots the conv state there too.
    """
    s = cfg.ssm
    d_inner, H, _ = mamba_dims(cfg)
    h = norm(cfg, x, bp["ln"])
    proj = h @ _w(bp, "in_proj", cfg)
    z, xs, bmat, cmat, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xs, bmat, cmat], dim=-1)
    conv_out, conv_state = _causal_conv(
        conv_in, _w(bp, "conv_w", cfg), _w(bp, "conv_b", cfg), state_len=state_len)
    conv_out = F.silu(conv_out)
    gn = s.n_groups * s.state
    xs, bmat, cmat = torch.split(conv_out, [d_inner, gn, gn], dim=-1)

    B_, T = x.shape[:2]
    xh = xs.reshape(B_, T, H, s.head_dim)
    bm = bmat.reshape(B_, T, s.n_groups, s.state)
    cm = cmat.reshape(B_, T, s.n_groups, s.state)
    dtv = F.softplus(dt.float() + bp["dt_bias"].float())
    if valid is not None:
        dtv = torch.where(valid[..., None], dtv, 0.0)
    A = -torch.exp(bp["A_log"].float())
    y, ssm_state = _ssd(cfg, xh, dtv, A, bm, cm)
    y = norm_gated(cfg, y, xh, z, bp["D_skip"], bp["out_ln"])
    out = x + y @ _w(bp, "out_proj", cfg)
    if return_state:
        return out, (ssm_state, conv_state)
    return out


def mamba_state_specs(cfg: ArchConfig, n_layers: int, batch: int) -> dict:
    """The recurrent leaves (L, batch, ...) as meta tensors."""
    s = cfg.ssm
    _, H, conv_ch = mamba_dims(cfg)
    return {
        "ssm": torch.empty((n_layers, batch, H, s.state, s.head_dim),
                           dtype=torch.float32, device="meta"),
        "conv": torch.empty((n_layers, batch, s.conv_kernel - 1, conv_ch),
                            dtype=dtype_of(cfg.compute_dtype), device="meta"),
    }


def mamba_block_decode(cfg: ArchConfig, x, bp, ssm_state, conv_state):
    """x: (B,D) one token.  Returns (x', ssm_state', conv_state')."""
    s = cfg.ssm
    d_inner, H, _ = mamba_dims(cfg)
    h = norm(cfg, x, bp["ln"])
    proj = h @ _w(bp, "in_proj", cfg)
    z, xs, bmat, cmat, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xs, bmat, cmat], dim=-1)[:, None]
    conv_out, conv_state = _causal_conv(
        conv_in, _w(bp, "conv_w", cfg), _w(bp, "conv_b", cfg), conv_state)
    conv_out = F.silu(conv_out[:, 0])
    gn = s.n_groups * s.state
    xs, bmat, cmat = torch.split(conv_out, [d_inner, gn, gn], dim=-1)
    B_ = x.shape[0]
    xh = xs.reshape(B_, H, s.head_dim)
    bm = bmat.reshape(B_, s.n_groups, s.state)
    cm = cmat.reshape(B_, s.n_groups, s.state)
    dtv = F.softplus(dt.float() + bp["dt_bias"].float())
    A = -torch.exp(bp["A_log"].float())
    ssm_state, y = ssd_decode_step(ssm_state, xh, dtv, A, bm, cm)
    y = norm_gated(cfg, y, xh, z, bp["D_skip"], bp["out_ln"])
    return x + y @ _w(bp, "out_proj", cfg), ssm_state, conv_state
