"""Plain PyTorch version of the flat Adam kernel: ``optim.flat.flat_adam_update``
with the decoupled weight decay folded in after it, exactly as the
reference's ``repro/kernels/flat_adam/ref.py`` folds it."""
from __future__ import annotations

from repro_torch.optim.flat import flat_adam_update


def flat_adam_ref(p, g, m, v, step, *, lr, beta1=0.9, beta2=0.95, eps=1e-8,
                  weight_decay=0.0):
    """p, g, m, v: (n,) fp32; step: the 1-based step, a (1,) or () int
    tensor.  Returns (p', m', v')."""
    s = step.reshape(())
    p_new, m_new, v_new = flat_adam_update(p, g, m, v, s, lr=lr, beta1=beta1,
                                           beta2=beta2, eps=eps)
    if weight_decay:
        p_new = p_new - lr * weight_decay * p
    return p_new, m_new, v_new
