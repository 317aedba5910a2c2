"""A bound on each socket test's wall time, for the tests of the port's
gRPC plane (tests/test_torch_h2.py, _grpc.py, _proxy.py, _tracing.py).

Calls of the reference's API take no timeout (grpc's blocking calls wait
for ever), so a stalled stream would hold the suite. ``stall_guard`` arms
SIGALRM for ``STALL_S`` seconds around each test: the handler raises in
the test's thread, which fails the test; grpcio and the port's channel both
wait in slices that let the handler run. pytest-timeout is not assumed.
"""

import signal

import pytest

STALL_S = 120


@pytest.fixture(autouse=True)
def stall_guard():
    def stalled(signum, frame):
        raise TimeoutError(f"the test ran past {STALL_S} s: a stalled stream?")

    previous = signal.signal(signal.SIGALRM, stalled)
    signal.alarm(STALL_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)
