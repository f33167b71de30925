"""Markers of the benchmark's own tests: `slow` (CPU rehearsals of whole
runs) and `gpu` (runs on the card; they decide in a fixture)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skips where CUDA is absent")
    config.addinivalue_line(
        "markers", "slow: a whole run of a cell, rehearsed on the CPU")
