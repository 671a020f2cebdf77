"""Registers the marker of tests that need a CUDA card (see README.md)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped on hosts without one")
