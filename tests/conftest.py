"""Test-process environment: forced multi-device host platform + shared rng.

XLA_FLAGS must be set before the first jax backend initialization, and
conftest is imported before any test module, so this is the one place the
whole suite can be given a deterministic device count. Forcing 4 host CPU
devices makes the sharded serving path (tests/test_sharding.py) testable
without hardware while leaving single-device tests untouched (unsharded
computation runs on device 0 regardless of how many devices exist).

The count is overridable — CI runs a second matrix job with a different
XLA_FLAGS to check the suite is really device-count parametrized, and
repro.launch.dryrun still owns its own 512-device override (it sets the flag
itself before importing jax, outside pytest).
"""
import os

_FORCE = "--xla_force_host_platform_device_count"
_flags = os.environ.get("XLA_FLAGS", "")
if _FORCE not in _flags:
    os.environ["XLA_FLAGS"] = f"{_flags} {_FORCE}=4".strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _trace_span_check():
    """Sweep lifecycle-trace recorders after every test.

    Any engine a test built (telemetry is on by default) registered its
    TraceRecorder in serve/trace._LIVE; draining it here validates the
    event schema and the span accounting — a request retired without a
    `finish` event (a span leak) fails the test that leaked it, with the
    engine's own state as the cross-check while it is still alive. The
    import happens lazily so collecting tests that never touch the serving
    stack doesn't pull it in.
    """
    yield
    import sys
    trace_lib = sys.modules.get("repro.serve.trace")
    if trace_lib is None:       # test never imported the serving stack
        return
    errors = []
    for rec in trace_lib.drain_recorders():
        errors += rec.validate()
        errors += rec.check_leaks()
    assert not errors, "trace span leaks/schema violations:\n" + \
        "\n".join(errors)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips (inside the test) without "
        "one. Run on the card: python -m pytest -m gpu tests/")
