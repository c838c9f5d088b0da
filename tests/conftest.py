"""Ensures the tests directory is importable (for hypothesis_compat)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips where there is none)"
    )
