"""Fused RMSNorm and residual-add RMSNorm (replaces the Pallas
``_rmsnorm_kernel`` and ``_rmsnorm_add_kernel``)."""
