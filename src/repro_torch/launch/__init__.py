"""Serving entry points (counterpart of `repro.launch`)."""
