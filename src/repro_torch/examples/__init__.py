"""Runnable examples of the port, each the counterpart of a script under
the repo's ``examples/``."""
