"""The comparison fails what it must: each fault a cell can have, planted
in the port under a run that skips the look for a card, and the control,
the reference in bfloat16 at its float32 sites (tiny sizes, CPU)."""
from __future__ import annotations

import pytest
import torch

from simbench import system, tiny  # noqa: F401 (system: the port's path)
from simbench.control import control_numbers

CELLS = [w["name"] for w in tiny.manifest()["workloads"]]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def unchanged_state(mp):
    """A window that returns the carry it was given."""
    from repro_torch.kvstore import fleet, simulator

    real = simulator.window_step

    def step(*args):
        _, metrics = real(*args)
        return args[5], metrics

    mp.setattr(simulator, "window_step", step)
    mp.setattr(fleet, "window_step", step)


def half_the_batch(mp):
    """The clients' batch with half of its requests left out: each
    window's Poisson count halved before the lanes are filled."""
    from repro_torch.kvstore import client

    real = client.generate

    class Half:
        def __init__(self, draws):
            self.draws = draws

        def draw(self, offered, b):
            n, u, w = self.draws.draw(offered, b)
            return n // 2, u, w

    def generate(st, cfg, draws, *rest):
        return real(st, cfg, Half(draws), *rest)

    mp.setattr(client, "generate", generate)


def altered_answer(mp):
    """One server's count of requests served, off by one where it is
    produced."""
    from repro_torch.kvstore import simulator

    real = simulator.server_step

    def server_step(*args):
        st, out = real(*args)
        bump = torch.zeros_like(out.served_now)
        bump[0] = 1
        return st, out._replace(served_now=out.served_now + bump)

    mp.setattr(simulator, "server_step", server_step)


FAULTS = {"unchanged_state": unchanged_state,
          "half_the_batch": half_the_batch,
          "altered_answer": altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_in_the_port_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = tiny.run(name, seed=99)
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["check"].values())


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    config, traffic = tiny.sized(name)
    numbers = control_numbers(config, traffic, 5, "cpu")
    assert max(numbers.values()) > 0, numbers


def test_the_first_call_follows_every_point(monkeypatch):
    """A fault in one point of the fleet that the sample does not follow
    still fails the run: call 0 compares every point."""
    from repro_torch.kvstore import client

    from simbench import check

    name, seed = "orbitcache-rack.ladder12", 99
    _, traffic = tiny.sized(name)
    n = len(traffic["points"]["offered_rps"])
    sampled = check.sample_plan(seed, n)["point"]
    target = seed + next(i for i in reversed(range(n)) if i != sampled)
    real = client.TorchDraws.draw

    def draw(self, offered, b):
        k, u, w = real(self, offered, b)
        return (k // 2 if self.gen.initial_seed() == target else k), u, w

    monkeypatch.setattr(client.TorchDraws, "draw", draw)
    res = tiny.run(name, seed=seed)
    assert res["correct"] is False
    assert res["check"]["call0_mismatch"]["value"] > 0
    assert res["check"]["sample_mismatch"]["value"] == 0
