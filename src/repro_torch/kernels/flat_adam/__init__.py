"""Fused flat-buffer Adam (replaces the Pallas ``_adam_kernel``)."""
