"""Mixture-of-experts FFN (Qwen3-style: a softmax-gated top-k of E experts,
renormalised over the k, with capacity slots), on one device or with its
experts split over a mesh program's model axis.

The port of the reference's ``models/moe.py``: ``moe_ffn`` has the same
steps, names and returns as the reference's ``shard_fn``:

  1. fp32 router logits (T, E), the top k of each row, softmax over them;
  2. a sort-based position of each (token, choice) in its expert (a stable
     argsort of the chosen experts, ``searchsorted`` for each expert's first
     row: no (T, E, C) one-hot);
  3. capacity ``C = expert_capacity(T)`` slots per expert, choices past it
     dropped, and an extra sentinel expert row that takes the dropped ones;
     unused slots index token T, a zero row;
  4. the tokens gathered into (E, C, D), each expert's SwiGLU as batched
     products (``torch.bmm``, as the reference's ``einsum``; no Pallas
     kernel is involved), each slot scaled by its gate weight;
  5. the combine back to the tokens.

Every token of ``x`` is routed and takes capacity, padding rows and idle
decode lanes included, as the reference routes them: masking them out
would change which tokens drop.

Expert parallelism (under a mesh program, ``common.model_axis()``): the
weights are this rank's ``E / N`` experts, ``e_off = rank E_loc`` on.  As
the reference's ``shard_fn``, the layer gathers the data column's tokens
over the model axis where the residual stream is sequence-sharded
(``common.tp_enter``), routes all of them on every model rank (the same
routing everywhere), fills only its own experts' slots (a choice of
another rank's expert goes to the sentinel row), and reduce-scatters the
combine back onto the sequence shard (``common.tp_exit``; all-reduced
where the stream is not sharded).  The load-balance term is computed from
the whole column on every rank, so its gradient is scaled by ``1 / N``:
the router's and the tokens' gradients are summed over the model axis.
``drop_frac`` is what the reference reports on such a mesh: its
``dropped`` leaves the ``shard_map`` through ``out_specs=P()``, which
returns model rank 0's value, and its ``keep`` counts a choice of another
rank's expert as dropped; so the port reports ``1 - mean(kept and routed
to one of rank 0's experts)`` on every rank (0.4375 with nothing dropped
at model 2 on the smoke config, as the reference's), the share of
choices dropped by capacity only at model 1.

Three choices keep the layer capturable in a CUDA graph and its results
the same from run to run, where the reference's XLA program is both by
construction:

* no host sync and no shape that depends on data: no ``nonzero``,
  ``unique`` or ``.item()``; token ids are ``arange(T * K) // K``;
* the top k come from a stable descending sort, so among equal logits the
  lower expert comes first, as ``jax.lax.top_k`` orders them (``torch.topk``
  promises no order on CUDA; ties are real where rows repeat);
* the combine is a gather, not the reference's scatter-add: each token
  adds its k weighted slots in ascending expert order, the order in which
  the reference's scatter visits them, in the output dtype, with no
  atomics.  ``index_add_`` on CUDA would add in an order that changes from
  run to run.

The layer reads every expert's weights at every call: the (E, C, D) layout
computes each expert's C slots whether or not a token was routed there.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from .common import GradScale, model_axis, tp_enter, tp_exit


def expert_capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert for ``n_tokens`` routed tokens: ``ceil(T k / E *
    capacity_factor)``, at least ``min(T k, 8)`` (decode-sized batches),
    rounded up to a multiple of 8."""
    moe = cfg.moe
    c = int(math.ceil(n_tokens * moe.top_k / moe.num_experts * moe.capacity_factor))
    c = max(c, min(n_tokens * moe.top_k, 8))
    return int(math.ceil(c / 8) * 8)


def route(xt: torch.Tensor, router_w: torch.Tensor, k: int):
    """fp32 logits (T, E), and the top ``k`` of each row as (softmax
    weights, expert ids), (T, k) each, in descending logit order, the lower
    expert first among equal logits."""
    logits = xt.float() @ router_w.float()
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return logits, torch.softmax(vals[:, :k], dim=-1), ids[:, :k]


def moe_ffn(x, router_w, w_gate, w_up, w_down, *, cfg: ArchConfig):
    """x: (..., D) in the compute dtype; router_w (D, E); w_gate, w_up (E,
    D, F); w_down (E, F, D) (under a mesh program this rank's ``E / N``
    experts, and ``x`` (B, S, D) in the residual layout).  Returns ``(out
    of x's shape and dtype, {"lb_loss", "drop_frac"})``, fp32 scalars: the
    Switch-style load-balance term ``E * sum_e f_e p_e`` (f_e the share of
    tokens whose first choice is e, p_e the mean router probability) and
    the share of choices dropped by capacity (at a model axis of N > 1 the
    reference's report, see the module docstring)."""
    E, K, D = cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model
    tp = model_axis()
    x_col = tp_enter(x)
    xt = x_col.reshape(-1, D)
    T = xt.shape[0]
    C = expert_capacity(T, cfg)
    dev = xt.device
    E_loc = w_gate.shape[0]
    e_off = 0 if tp is None else tp.rank * E_loc

    logits, topk_w, topk_i = route(xt, router_w, K)
    flat_e = topk_i.reshape(-1)                               # (T K,)
    flat_w = topk_w.reshape(-1)
    flat_t = torch.arange(T * K, device=dev) // K

    # position of each choice in its expert: rank within a stable sort
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    ranks = torch.arange(T * K, device=dev) - starts[sorted_e]
    pos = torch.empty_like(flat_e).scatter_(0, order, ranks)

    # capacity slots of this rank's experts; dropped choices (and, under a
    # model axis, other ranks' experts) go to the sentinel expert row E_loc
    keep = pos < C
    if tp is not None:
        fits = keep
        keep = fits & (flat_e >= e_off) & (flat_e < e_off + E_loc)
    slot = torch.where(keep, flat_e - e_off, E_loc) * C + pos.clamp(0, C - 1)
    idx_buf = torch.full(((E_loc + 1) * C,), T, dtype=torch.long, device=dev)
    idx_buf = idx_buf.scatter_(0, slot, flat_t)[: E_loc * C].view(E_loc, C)
    w_buf = torch.zeros((E_loc + 1) * C, dtype=torch.float32, device=dev)
    w_buf = w_buf.scatter_(0, slot, flat_w)[: E_loc * C].view(E_loc, C)

    # the experts: (E_loc, C, D) batched SwiGLU, each slot scaled by its weight
    cdt = xt.dtype
    xs = torch.cat([xt, xt.new_zeros(1, D)])[idx_buf]         # token T: zeros
    g = torch.bmm(xs, w_gate.to(cdt))
    u = torch.bmm(xs, w_up.to(cdt))
    y = torch.bmm(F.silu(g) * u, w_down.to(cdt))
    y = y * w_buf[..., None].to(y.dtype)

    # combine: token t adds its kept slots in ascending expert order (a
    # dropped choice reads the zero row E_loc C)
    taken = torch.where(keep, slot, E_loc * C).view(T, K)
    taken = taken.gather(1, torch.sort(topk_i, dim=-1).indices)
    parts = torch.cat([y.reshape(E_loc * C, D), y.new_zeros(1, D)])[taken]   # (T, K, D)
    out = parts[:, 0]
    for j in range(1, K):
        out = out + parts[:, j]
    out = tp_exit(out.reshape(x_col.shape))

    probs = torch.softmax(logits, dim=-1)
    frac = F.one_hot(topk_i[:, 0], E).float().mean(0)
    lb = E * torch.sum(frac * probs.mean(0))
    if tp is not None and tp.world > 1:
        lb = GradScale.apply(lb, 1.0 / tp.world)
        keep = fits & (flat_e < E_loc)                # model rank 0's report
    # 1 - mean(keep) as the reference's compiled program computes it: the
    # kept count times the fp32 reciprocal of T K, subtracted from 1 and
    # rounded once (a fused multiply-add; the count and the reciprocal's
    # product are exact in fp64)
    recip = torch.tensor(1.0 / (T * K), dtype=torch.float32).item()
    dropped = (1.0 - keep.double().sum() * recip).float()
    return out.reshape(x.shape).to(x.dtype), {"lb_loss": lb, "drop_frac": dropped}


def moe_ffn_reference(x, router_w, w_gate, w_up, w_down, *, cfg: ArchConfig):
    """Dense oracle: every expert for every token, no capacity (equal to
    ``moe_ffn`` wherever nothing drops, up to summation order)."""
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    xt = x.reshape(-1, x.shape[-1])
    logits, topk_w, topk_i = route(xt, router_w, K)
    weights = torch.zeros(xt.shape[0], E, dtype=torch.float32, device=xt.device)
    weights = weights.scatter_(1, topk_i, topk_w)
    g = torch.einsum("td,edf->tef", xt, w_gate.to(xt.dtype))
    u = torch.einsum("td,edf->tef", xt, w_up.to(xt.dtype))
    y = torch.einsum("tef,efd->ted", F.silu(g) * u, w_down.to(xt.dtype))
    out = torch.einsum("ted,te->td", y.float(), weights)
    return out.reshape(x.shape).to(x.dtype)
