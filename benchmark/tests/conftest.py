"""The benchmark's CPU tests.  Tests that need a CUDA card carry the
``card`` marker and skip themselves where none is visible."""

import os


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")
    if os.environ.get("PYTEST_XDIST_WORKER"):
        # the stages' plain CPU DP on every core in every worker
        # oversubscribes the host many times over
        import torch

        torch.set_num_threads(1)
