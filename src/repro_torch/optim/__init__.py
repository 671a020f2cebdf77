"""The in-house AdamW (counterpart of `repro.optim`)."""
