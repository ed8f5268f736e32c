"""Start-up of ``gloo`` process groups for the tests, without a TCP port.

Ranks meet through a ``FileStore`` in a directory of the test's own
(``init_method=f"file://{store}"``), so groups started at once by several
xdist workers cannot race for a port.  A rank script is run as
``python -c script *args rank store`` and calls

    tdist.init_process_group("gloo", init_method=f"file://{store}",
                             rank=rank, world_size=n)

and prints ``RANK_OK <rank>`` when its checks pass.
"""
import contextlib
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))


def child_env():
    """The environment of a test's child process: one thread, and the
    port's and the tests' modules on its path."""
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "..", "src"), HERE]))


@contextlib.contextmanager
def one_rank_group(where):
    """A one-rank ``gloo`` group in this process, its store under
    ``where``; destroyed on exit."""
    import torch.distributed as tdist

    tdist.init_process_group("gloo", init_method=f"file://{where}/store",
                             rank=0, world_size=1)
    try:
        yield
    finally:
        tdist.destroy_process_group()


def run_ranks(script, args, where, n, timeout):
    """Run ``n`` ranks of ``script`` (argv: ``*args``, rank, store path),
    their store and output files under ``where``; all share one deadline
    of ``timeout`` seconds.  Stops the others as soon as one rank fails,
    and fails unless every rank exits 0 and prints ``RANK_OK <rank>``.
    Returns their standard outputs."""
    store = Path(where) / "store"
    logs = [(Path(f"{store}.{r}.out"), Path(f"{store}.{r}.err"))
            for r in range(n)]
    procs = []
    for r, (out, err) in enumerate(logs):
        with open(out, "w") as o, open(err, "w") as e:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, *map(str, args), str(r),
                 str(store)], env=child_env(), stdout=o, stderr=e))
    deadline = time.monotonic() + timeout
    codes = [None] * n
    try:
        while None in codes and not any(codes) and \
                time.monotonic() < deadline:
            time.sleep(0.1)
            codes = [p.poll() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    tail = lambda r: f"rank {r} stderr:\n{logs[r][1].read_text()[-3000:]}"
    for r, c in enumerate(codes):
        assert not c, f"rank {r} of {n} exited {c}\n{tail(r)}"
    late = [r for r, c in enumerate(codes) if c is None]
    assert not late, (f"ranks {late} of {n} still ran after {timeout} s\n"
                      + "\n".join(map(tail, late)))
    outs = [out.read_text() for out, _ in logs]
    for r, out in enumerate(outs):
        assert f"RANK_OK {r}" in out, (r, out, tail(r))
    return outs
