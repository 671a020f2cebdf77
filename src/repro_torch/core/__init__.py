"""Core library of the port: the analytical laws the kernels share.

Counterpart of `repro.core`.  Only `cost_model`'s block-skip law of the
flash-attention kernel is ported so far; the tuning engine's time models
follow with ROADMAP A8.
"""
