"""Every cell end to end at the tiny size on the CPU (``simbench.tiny``):
the result line's keys, the numbers compared, and the reference's
agreement with the port; the command's refusals."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from simbench import tiny

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CELLS = [w["name"] for w in tiny.manifest()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_agrees_with_the_reference(name, trace):
    res = tiny.run(name, seed=2**31 + 7, trace=bool(trace))
    assert list(res) == KEYS        # no breakdown: no card, no profile
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] > 0
    assert {k: v["value"] for k, v in res["check"].items()} == dict.fromkeys(
        res["check"], 0)
    assert all(v["limit"] == 0 for v in res["check"].values())
    man = tiny.manifest()
    section = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in man[section]}
    assert set(res["metrics"]) <= names
    if not trace:
        assert set(res["metrics"]) == names
        assert res["metrics"]["windows_per_s"]["value"] > 0
    assert json.loads(json.dumps(res)) == res
    assert res["device"]["count"] == 1


def test_the_compared_stretches_do_work():
    """At the tiny size the racks serve: the comparison is not of empty
    windows."""
    from simbench import check

    config, traffic = tiny.sized("orbitcache-rack.static-4m")
    spec = check.cell_spec(config, traffic, 3)
    (start, ((traces, hs, hv), _), after), = check.run_jobs(
        spec, [check.start_job(spec, 0, "cpu")], 1)
    assert traces["rx_switch"].sum() > 0 and traces["rx_server"].sum() > 0
    assert hs.sum() > 0 and hv.sum() > 0


def command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "simbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def test_command_refuses_without_a_card():
    out = command(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_command_refuses_without_the_port(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "simbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "src/repro_torch" in out.stderr


def test_worker_processes_give_the_in_process_answers():
    """The card's runs step the reference in worker processes: the same
    jobs give the same answers there."""
    from simbench import check

    config, traffic = tiny.sized("orbitcache-rack.ladder12")
    spec = check.cell_spec(config, traffic, 11)
    jobs = lambda: [check.start_job(spec, i, "cpu") for i in range(2)]
    here = check.run_jobs(spec, jobs(), 1)
    there = check.run_jobs(spec, jobs(), 2)
    notes: list[str] = []
    for (s1, c1, a1), (s2, c2, a2) in zip(here, there):
        assert check.differ(s1, s2, "start", notes) == 0
        assert check.call_differ(c1, c2, "call 0", notes) == 0
        assert check.differ(a1, a2, "carry", notes) == 0


def test_recorded_draws_replay_the_generator():
    from simbench.reference.kvstore.client import RecordedDraws, TorchDraws

    lam = torch.tensor(3.5, dtype=torch.float32)
    rec = RecordedDraws.record(TorchDraws(2**33 + 5, "cpu"), 3.5, 16, 3,
                               "cpu")
    live = TorchDraws(2**33 + 5, "cpu")
    assert torch.equal(rec.get_state(), live.get_state())
    for _ in range(3):
        for a, b in zip(rec.draw(lam, 16), live.draw(lam, 16)):
            assert torch.equal(a, b)
        assert torch.equal(rec.get_state(), live.get_state())
    with pytest.raises(RuntimeError, match="recorded"):
        rec.draw(lam, 16)
    with pytest.raises(ValueError, match="another state"):
        RecordedDraws.record(live, 3.5, 16, 1, "cpu").set_state(
            TorchDraws(1, "cpu").get_state())
