"""Suite-wide settings for ``tests/`` and ``simbench/``.

* A thread budget: each xdist worker gets its share of the host's cores
  for torch's intra-op pool (``OMP_NUM_THREADS``, which torch reads when
  it is imported, after this file).
* A time limit for every test: each phase (setup, call, teardown) that
  runs past ``LIMIT`` fails, named by its node id, and the run goes on.
  ``SIGALRM`` ends the phase at the next Python bytecode (xdist runs each
  test in its worker's main thread, where the handler runs).  A phase
  blocked in C gets its threads' stacks dumped ``GRACE`` seconds later by
  faulthandler's watchdog.  Without xdist it then fails when the call
  returns; under xdist the watchdog ends the worker, xdist reports the
  test failed and starts a new worker, and the run goes on.  xdist's
  ``--dist loadfile`` sends that test to a worker again: each worker names
  the test it runs in a file beside the other workers', and fails at once
  a test that a stopped worker was running.
"""
import faulthandler
import os
import signal
import sys
from pathlib import Path

import pytest

# s a phase may take: 1.95 times the slowest test in the 6-worker suite on
# 4 cores (154.1 s, test_fabric.py::test_batched_fabric_matches_serial_fabric)
LIMIT = 300.0
GRACE = 5.0     # s past the limit before the watchdog dumps a C-blocked phase

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
if _workers:
    _threads = max(1, len(os.sched_getaffinity(0)) // _workers)
    os.environ.setdefault("OMP_NUM_THREADS", str(_threads))

_dump_fd = None
_phase = None       # the node id of the phase whose timer is armed
_running = None     # under xdist: the file naming the test this worker runs


def pytest_configure(config):
    global _dump_fd, _running
    _dump_fd = os.dup(sys.__stderr__.fileno())
    signal.signal(signal.SIGALRM, _on_alarm)
    if hasattr(config, "workerinput"):
        # the worker's base temp dir is popen-<id> in the run's own
        _running = Path(config.option.basetemp).with_name(
            f"running-{config.workerinput['workerid']}")


def pytest_unconfigure(config):
    os.close(_dump_fd)
    if _running is not None:
        _running.unlink(missing_ok=True)


def _on_alarm(signum, frame):
    if _phase is None:
        return
    faulthandler.cancel_dump_traceback_later()
    msg = f"{_phase} ran past its {LIMIT:g} s limit"
    os.write(_dump_fd, f"\n{msg}; its threads:\n".encode())
    faulthandler.dump_traceback(file=_dump_fd, all_threads=True)
    pytest.fail(msg)


def _within_limit(item):
    global _phase
    _phase = item.nodeid
    faulthandler.dump_traceback_later(LIMIT + GRACE, exit=_running is not None,
                                      file=_dump_fd)
    signal.setitimer(signal.ITIMER_REAL, LIMIT)
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        _phase = None


def _stopped_in(nodeid):
    """The xdist worker that was stopped while it ran ``nodeid``, if any."""
    for other in _running.parent.glob("running-*"):
        try:
            if other != _running and other.read_text() == nodeid:
                return other.name.removeprefix("running-")
        except FileNotFoundError:       # its worker ended meanwhile
            pass


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    if _running is not None:
        worker = _stopped_in(item.nodeid)
        if worker is not None:
            pytest.fail(f"{item.nodeid} ran past its {LIMIT:g} s limit in C, "
                        f"and its worker {worker} was stopped")
        _running.write_text(item.nodeid)
    return (yield from _within_limit(item))


pytest_runtest_call = pytest.hookimpl(wrapper=True)(_within_limit)
pytest_runtest_teardown = pytest.hookimpl(wrapper=True)(_within_limit)
