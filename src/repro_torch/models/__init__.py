"""Model configs and the dense model (counterpart of `repro.models`)."""
