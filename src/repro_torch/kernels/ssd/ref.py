"""Plain PyTorch versions of the SSD scan.

``ssd_chunked_ref`` is the model's chunked scan (``models/ssm.py``:
y in fp32 and, with ``return_state``, the final state): the plain version
of the kernel's model-layout entry, repeating its arithmetic.  ``ssd_ref``
is the step-by-step recurrence in the TPU kernel's layout, matching the
reference's ``kernels/ssd/ref.py`` (the oracle of the parity tests).
"""
from __future__ import annotations

from repro_torch.models.ssm import ssd_chunked as ssd_chunked_ref
from repro_torch.models.ssm import ssd_reference


def ssd_ref(x, dt, A, Bm, Cm):
    """x: (B, H, T, P); dt: (B, H, T); A: (H,); Bm/Cm: (B, G, T, N).
    Returns y (B, H, T, P) in x.dtype."""
    y = ssd_reference(x.transpose(1, 2), dt.transpose(1, 2), A,
                      Bm.transpose(1, 2), Cm.transpose(1, 2))
    return y.transpose(1, 2).to(x.dtype)


__all__ = ["ssd_chunked_ref", "ssd_ref"]
