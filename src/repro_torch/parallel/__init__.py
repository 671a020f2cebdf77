"""Losses of the port (counterpart of `repro.parallel`; sharding and
gradient compression are ROADMAP A14)."""
