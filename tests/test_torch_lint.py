"""The port's structural lint (``repro_torch.analysis``): every rule fires
on its seeded violation and passes its clean twin, the six production
entry points are clean on the CPU, and the registry is complete.

A rule without a fixture that proves it fires is assumed dead
(``tests/test_lint.py`` holds the reference's lint to the same).  The
card-only parts (profiled kernel counts, graph memory, recapture on a
real sweep) run in ``chip_smoke.py``'s ``analysis`` phase.
"""
import inspect
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as kn  # noqa: E402
from repro_torch.analysis import fixtures as fx  # noqa: E402
from repro_torch.analysis.entry_points import build_entry_points  # noqa: E402
from repro_torch.analysis.findings import Severity, errors  # noqa: E402
from repro_torch.analysis.lint import main as lint_main  # noqa: E402
from repro_torch.analysis.op_trace import trace  # noqa: E402
from repro_torch.analysis.profile import op_summary  # noqa: E402
from repro_torch.analysis.rules import (  # noqa: E402
    ALLOWLISTS, RULES, op_records,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENTRY_NAMES = ("subround_pipeline", "window_pipeline",
               "compiled_controller_chunk", "fleet.window_step",
               "fabric_window_step", "fabric_controller_chunk")

@pytest.mark.parametrize("rule", sorted(fx.cases()))
def test_rule_fires_on_fixture_and_passes_twin(rule):
    bad, good, op, fn_name = fx.cases()[rule]
    found = RULES[rule](bad)
    assert found, f"{rule} did not fire on its seeded violation"
    for f in found:
        assert f.rule == rule and f.severity == Severity.ERROR
        assert f.op == op, f.format()
        assert f.site.startswith(f"{fn_name} @ repro_torch/analysis/"
                                 f"fixtures.py:"), f.format()
    clean = RULES[rule](good)
    assert clean == [], "\n".join(f.format() for f in clean)


def test_fixture_findings_point_at_the_line():
    """An op finding names the body run, the op's place and the line."""
    (f0, *_) = RULES["no-scatter"](fx.cases()["no-scatter"][0])
    line = next(i for i, ln in enumerate(inspect.getsource(fx).splitlines(),
                                         1) if "# per-lane scatter" in ln)
    assert f0.site.endswith(f":{line}")
    assert re.fullmatch(r"call\[0\]/op\[\d+\]", f0.path)


@pytest.fixture(scope="module")
def cpu_entries():
    return {e.name: e for e in build_entry_points(device="cpu")}


@pytest.mark.parametrize("name", ENTRY_NAMES)
def test_production_entry_clean_on_cpu(name, cpu_entries):
    """Every rule that runs on the CPU holds on the entry (the recapture
    guard has no sweep here: a CPU chunk captures nothing)."""
    entry = cpu_entries[name]
    found = [f for r in RULES.values() for f in r(entry)]
    assert errors(found) == [], "\n".join(f.format() for f in found)
    recs = op_records(entry)
    assert recs, "the recorder saw no op in a body"
    assert not any("repro_torch/kernels/" in r.site
                   or r.op.startswith("repro_torch.") for r in recs)
    assert entry.harness().sweep is None


def test_kernel_calls_counted_on_ref(cpu_entries):
    """On ``ref`` a run makes the documented dispatcher calls and launches
    nothing: the number the card's launches must equal."""
    h = cpu_entries["fabric_controller_chunk"].harness()
    h.run()
    kn.reset_launch_counts()
    h.run()
    assert kn.CALLS == dict(subround=8, cms=2, hot_gather=6, orbit_match=0,
                            reply_values=2, server_enqueue=2)
    assert not any(kn.LAUNCHES.values())


def test_recorder_sees_vmapped_ops_and_marks_bodies():
    x = torch.arange(6.0).reshape(2, 3)
    recs = trace(lambda: torch.func.vmap(fx.scatter_free_loop)(x))
    assert {r.body for r in recs} == {"call"}
    assert any(r.site.startswith("scatter_free_loop @ ") for r in recs)
    assert [r.position for r in recs] == list(range(len(recs)))
    summary = op_summary(recs)
    assert summary.total == len(recs) and summary.counts["aten.where.self"]


def test_registry_is_complete():
    assert set(RULES) == set(fx.cases())
    assert {e.name for e in build_entry_points(device="cpu")} \
        == set(ENTRY_NAMES)
    for name, fn in RULES.items():
        assert fn.rule_name == name and fn.__doc__
    # every allowlisted site is a function of the port, documented
    src = "\n".join(p.read_text() for p in
                    (ROOT / "src" / "repro_torch").rglob("*.py"))
    readme = (ROOT / "src" / "repro_torch" / "analysis" / "README.md"
              ).read_text()
    for rule, names in ALLOWLISTS.items():
        assert rule.split("-unique")[0] in RULES
        for n in names:
            assert re.search(rf"^\s*def {n}\(", src, re.M), n
            assert f"`{n}`" in readme, n


def test_cli_lists_and_lints_on_cpu(capsys):
    assert lint_main(["--list"]) == 0
    out = capsys.readouterr().out
    assert all(r in out for r in RULES) and all(n in out for n in ENTRY_NAMES)
    assert lint_main(["--device", "cpu", "--entries", "window_pipeline"]) == 0
    assert "0 error(s)" in capsys.readouterr().out


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_lint_clean_on_the_card(card):
    """All six rules over all six entries on the kernel backend: launches
    equal to the calls and to the profiler's kernels, no copy in a
    replayed chunk, no recapture over the sweeps."""
    from repro_torch.analysis.lint import run_lint

    found = run_lint(device=card)
    assert errors(found) == [], "\n".join(f.format() for f in found)
