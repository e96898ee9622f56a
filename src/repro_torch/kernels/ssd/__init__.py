"""Mamba2 SSD chunk scan (replaces the Pallas ``_ssd_kernel``)."""
