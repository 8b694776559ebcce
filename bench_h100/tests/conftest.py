"""The benchmark's own tests (CPU; the card's cases carry `gpu`)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")
