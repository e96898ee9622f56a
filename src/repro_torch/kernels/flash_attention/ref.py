"""Plain PyTorch version of the flash attention kernel (naive O(S^2)
memory), matching the reference's ``attention_ref``."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: (B, H, Sq, D); k/v: (B, Hk, Sk, D) with H % Hk == 0.
    Returns (B, H, Sq, D) in q.dtype."""
    B, H, Sq, D = q.shape
    _, Hk, Sk, _ = k.shape
    rep = H // Hk
    qf = q.float().reshape(B, Hk, rep, Sq, D)
    s = torch.einsum("bhrqd,bhkd->bhrqk", qf, k.float()) * (D ** -0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    pos_q = torch.arange(Sq, device=q.device)[:, None]
    pos_k = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= pos_k <= pos_q
    if window:
        ok &= pos_k > pos_q - window
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhrqk,bhkd->bhrqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)
