"""Losses, sharding rules and gradient compression of the port
(counterpart of `repro.parallel`)."""
