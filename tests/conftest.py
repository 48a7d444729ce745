"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests must see 1 real device
(the 512-device setup belongs exclusively to launch/dryrun.py subprocesses).
"""
import os
import signal
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "timeout(seconds): hard per-test wall-clock limit via SIGALRM — "
        "required on tests that spawn subprocesses (shard servers, mesh "
        "runs), so a hung child fails the test instead of the whole suite",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (CUDA kernels have no CPU mode); skips "
        "with a reason where torch.cuda.is_available() is False",
    )


@pytest.fixture(autouse=True)
def _per_test_timeout(request):
    """SIGALRM-based @pytest.mark.timeout(s) (no pytest-timeout in the env).

    Main-thread only, Unix only — both true for this suite; elsewhere the
    marker degrades to a no-op rather than failing collection.
    """
    marker = request.node.get_closest_marker("timeout")
    if marker is None or not hasattr(signal, "SIGALRM"):
        yield
        return
    seconds = int(marker.args[0])

    def _expired(signum, frame):
        raise TimeoutError(
            f"test exceeded its {seconds}s timeout "
            f"(a spawned subprocess probably hung)"
        )

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
