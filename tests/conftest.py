# NOTE: no XLA_FLAGS here — smoke tests and benches must see 1 device.
# Multi-device integration tests spawn subprocesses (tests/test_multidevice.py).
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA device; skips without one")
