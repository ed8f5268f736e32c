"""The suite's time limit (the root ``conftest.py``), through a child pytest
on a test file of its own, run plain and under xdist's ``--dist loadfile``:
a test that runs past its limit fails alone, within its limit, named in its
message and in a dump of its threads, and the rest of the run goes on; one
blocked in C past the watchdog's grace ends its xdist worker, fails, and
is not run again.
"""
import os
import re
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
LIMIT = 2       # s: the child's limit
SLACK = 5       # s a failed phase may take past its limit on a busy host

CHILD = '''
import os
import signal
import time

import pytest

NEVER = 600     # s: a wait that only a limit ends


@pytest.fixture
def stuck():
    time.sleep(NEVER)


def test_sleeps():
    time.sleep(NEVER)


def test_next():
    pass


def test_under_limit():
    time.sleep(0.5)


def test_stuck_in_setup(stuck):
    pass


def test_blocked_in_c():
    # SIGALRM held back past the limit (2 s) and the watchdog's grace (5 s):
    # a call that stays in C, where the handler cannot run.  Alone it
    # returns after 9 s; under xdist it never does, and the watchdog ends
    # the worker
    block = NEVER if "PYTEST_XDIST_WORKER" in os.environ else 9
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    try:
        time.sleep(block)
    finally:
        signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGALRM})


def test_after_blocked():
    pass
'''

MODES = {"plain": [],
         "xdist": ["-p", "xdist", "-n", "1", "--dist", "loadfile"]}


@pytest.fixture(scope="module", params=list(MODES))
def child(request, tmp_path_factory):
    """The child run's mode, return code, stdout, stderr, and each test's
    seconds (junit's; a list, as a test run again has two entries)."""
    where = tmp_path_factory.mktemp("limit")
    shutil.copy(ROOT / "pytest.ini", where)
    conftest, n = re.subn(r"^LIMIT = .*$", f"LIMIT = {LIMIT}",
                          (ROOT / "conftest.py").read_text(), flags=re.M)
    assert n == 1
    (where / "conftest.py").write_text(conftest)
    (where / "test_child.py").write_text(CHILD)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_")}
    # the waits end by their limits in 15-20 s; a limit that did not fire
    # leaves a 600 s sleep, which this timeout stops
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
         "--junitxml=child.xml", *MODES[request.param], "test_child.py"],
        cwd=where, env=env, capture_output=True, text=True, timeout=120)
    seconds = {}
    for case in ET.parse(where / "child.xml").iter("testcase"):
        seconds.setdefault(case.get("name"), []).append(float(case.get("time")))
    return request.param, p.returncode, p.stdout, p.stderr, seconds


def test_a_test_past_its_limit_fails_named(child):
    _, rc, out, err, _ = child
    assert rc == 1, out
    msg = f"test_child.py::test_sleeps ran past its {LIMIT} s limit"
    assert "FAILED test_child.py::test_sleeps" in out, out
    assert f"Failed: {msg}" in out, out
    assert f"{msg}; its threads:" in err, err
    assert "in test_sleeps" in err, err


def test_the_run_goes_on(child):
    mode, _, out, _, _ = child
    for name in ("test_next", "test_under_limit", "test_after_blocked"):
        assert f"PASSED test_child.py::{name}" in out, out
    # under xdist the blocked test fails as its worker's crash, then errs
    # where it is sent again
    errors = {"plain": "1 error", "xdist": "2 errors"}[mode]
    assert f"2 failed, 3 passed, {errors}" in out, out


def test_each_fails_within_its_limit(child):
    *_, seconds = child
    for name in ("test_sleeps", "test_stuck_in_setup"):
        [took] = seconds[name]
        assert LIMIT <= took < LIMIT + SLACK, (name, took)


def test_a_fixture_past_its_limit_errs_named(child):
    _, _, out, _, _ = child
    assert "ERROR test_child.py::test_stuck_in_setup" in out, out
    assert ("Failed: test_child.py::test_stuck_in_setup ran past its "
            f"{LIMIT} s limit") in out, out


def test_a_test_blocked_in_c_is_dumped_then_fails(child):
    mode, _, out, err, _ = child
    # the watchdog dumps at the limit plus the grace, while the C call
    # still runs
    assert "Timeout (0:00:07)!" in err, err
    assert "in test_blocked_in_c" in err, err
    if mode == "plain":
        # the test fails when the call returns
        assert (f"test_child.py::test_blocked_in_c ran past its {LIMIT} s "
                "limit") in out, out
    else:
        # the watchdog ends the worker; the test fails as its crash, and
        # at once where --dist loadfile sends it again
        assert ("worker 'gw0' crashed while running "
                "'test_child.py::test_blocked_in_c'") in out, out
        assert "ERROR test_child.py::test_blocked_in_c" in out, out
        assert ("Failed: test_child.py::test_blocked_in_c ran past its "
                f"{LIMIT} s limit in C, and its worker gw0 was stopped") in out, \
            out
