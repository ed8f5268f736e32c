"""``tests/ranks.py``: groups meet through a store of their own, so groups
started at once do not meet each other; a rank that fails or outstays the
deadline fails the call at once, with its exit code and its stderr."""
import concurrent.futures
import time

import pytest

from ranks import run_ranks

SUM = r"""
import sys
import torch
import torch.distributed as tdist

rank, store = int(sys.argv[1]), sys.argv[2]
tdist.init_process_group("gloo", init_method=f"file://{store}",
                         rank=rank, world_size=2)
try:
    x = torch.tensor([rank + 1])
    tdist.all_reduce(x)
    assert int(x) == 3, int(x)
    print(f"RANK_OK {rank}")
finally:
    tdist.destroy_process_group()
"""

GIVES_UP = r"""
import sys, time
if sys.argv[1] == "1":
    sys.stderr.write("rank 1 gives up\n")
    sys.exit(3)
time.sleep(60)
"""


def test_two_groups_started_at_once(tmp_path):
    wheres = [tmp_path / "a", tmp_path / "b"]
    for w in wheres:
        w.mkdir()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(run_ranks, SUM, [], w, n=2, timeout=120)
                for w in wheres]
        outs = [run.result(timeout=150) for run in runs]
    for group in outs:
        assert [f"RANK_OK {r}" in out for r, out in enumerate(group)] == \
            [True, True]


def test_a_failing_rank_stops_the_call(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(AssertionError) as e:
        run_ranks(GIVES_UP, [], tmp_path, n=2, timeout=60)
    assert time.monotonic() - t0 < 30
    assert "rank 1 of 2 exited 3" in str(e.value)
    assert "rank 1 gives up" in str(e.value)


def test_ranks_past_the_deadline_fail_the_call(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(AssertionError) as e:
        run_ranks("import time; time.sleep(60)", [], tmp_path, n=2,
                  timeout=2)
    assert time.monotonic() - t0 < 30
    assert "ranks [0, 1] of 2 still ran after 2 s" in str(e.value)
