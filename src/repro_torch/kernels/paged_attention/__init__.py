"""Paged decode attention (replaces the Pallas ``_paged_kernel``)."""
