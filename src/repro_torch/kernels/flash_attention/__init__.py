"""Flash attention forward and its recompute gradient (replaces the Pallas ``_fwd_kernel``)."""
