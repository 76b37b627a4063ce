import os
import sys

import pytest

# tests run with the default single CPU device; only subprocess-based tests
# (test_distributed, test_dryrun_smoke) override XLA_FLAGS in their children.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# hypothesis is an optional dev dependency (requirements-dev.txt): modules
# import these shims so their deterministic tests run everywhere and only
# the property-based tests skip when hypothesis is absent.
try:
    from hypothesis import given, settings, strategies as st  # noqa: F401
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

    def _noop_decorator(*args, **kwargs):
        return lambda f: f

    given = settings = _noop_decorator

    class _AnyStrategy:
        def __getattr__(self, name):
            return lambda *a, **k: None

    st = _AnyStrategy()

requires_hypothesis = pytest.mark.skipif(
    not HAVE_HYPOTHESIS, reason="hypothesis not installed")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips without them)")
