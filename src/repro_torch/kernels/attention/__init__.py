"""Attention kernels (counterpart of `repro.kernels.attention`)."""
