"""Per-test sweep of the port's lifecycle-trace recorders, for the test
files that build the port's ServeEngine (import the fixture by name).

Every engine with telemetry on registers its TraceRecorder in the port's
serve/trace registry; draining it after each test validates the event
schema and the span accounting — a request retired without a `finish`
event fails the test that leaked it — and keeps the registry from growing
across the test run. The reference package's recorders are swept by
tests/conftest.py."""
import sys

import pytest


@pytest.fixture(autouse=True)
def port_trace_sweep():
    yield
    trace_lib = sys.modules.get("repro_torch.serve.trace")
    if trace_lib is None:
        return
    errors = []
    for rec in trace_lib.drain_recorders():
        errors += rec.validate()
        errors += rec.check_leaks()
    assert not errors, "port trace span leaks / schema violations:\n" + \
        "\n".join(errors)
