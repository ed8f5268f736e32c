"""The benchmark's manifest, its readers, its byte counts, its trace
reduction and its imports (CPU only)."""
from __future__ import annotations

import ast
import json
import os
import re

import pytest

from simbench import trace
from simbench.metrics import kernel_bytes, reader

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
JAX_BENCHMARKS = "bench" + "marks/"   # the JAX package's folder, unread
PAPER = json.load(open(os.path.join(HERE, "configs",
                                    "orbitcache-paper-rack.json")))["rack"]


@pytest.fixture(scope="module")
def manifest():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) < 64 * 1024
    with open(path) as f:
        return json.load(f)


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_shape(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["simbench"]
    assert all(line(w) for w in manifest["command"])
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in manifest[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_and_cells(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("simbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert line(c["source"]) and line(c["why"])
    used = set()
    pairs = set()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and line(w["why"])
        assert NAME.match(w["traffic"]) and w["config"] in configs
        assert os.path.exists(os.path.join(HERE, "traffic",
                                           f"{w['traffic']}.json"))
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == set(configs)


def test_metrics_and_readers(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert set(e2e) == {"windows_per_s", "peak_device_mib", "setup_s"}
    for m in e2e.values():
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    assert e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and line(m["layer"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        mod = reader(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == (
            m["unit"], m["layer"], m["moves"], m["source"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in cells:
        per = [m for m in manifest["per_layer"]
               if c in m.get("workloads", cells)]
        assert per, c


def test_kernel_bytes_at_the_paper_shapes():
    assert kernel_bytes.lanes(PAPER) == (1408, 352)
    assert kernel_bytes.subround_bytes(PAPER) == 116_356
    assert kernel_bytes.cms_bytes(PAPER) == 3_010_048
    calls = kernel_bytes.hot_gather_calls(PAPER)
    assert calls == [(128, 2048, 1), (2048, 2048, 1), (2048, 128, 1)]
    assert kernel_bytes.hot_gather_bytes(*calls[1]) == 40_960


def sources():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_imports_no_jax_and_no_jax_package(path):
    """Top-level module names compared whole: ``repro_torch`` is not
    ``repro``.  The reference imports nothing of the port either, and no
    file reads the JAX package's ``benchmarks/``."""
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not node.value.startswith(JAX_BENCHMARKS), path
    assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    if os.sep + "reference" + os.sep in path:
        assert "repro_torch" not in tops


def spans(lead=3):
    """Records of a stretch: a lead-in, a stretch span, two calls and an
    idle gap under a swap."""
    ev = [("device", "spin_kernel", 0, 10) for _ in range(lead)]
    ev += [("host", "simbench.stretch", 100, 1_000_100),
           ("host", "simbench.call", 100, 400_000),
           ("host", "cudaGraphLaunch", 150, 200),
           ("device", "k_a", 1_000, 201_000),
           ("device", "k_b", 201_000, 301_000),
           ("device", "Memcpy DtoH", 301_000, 302_000),
           ("mark", "simbench.call", 100, 400_000),
           ("host", "simbench.swap", 400_000, 700_000),
           ("host", "aten::copy_", 450_000, 650_000),
           ("host", "simbench.call", 700_000, 1_000_000),
           ("device", "k_a", 700_005, 999_000)]
    return ev


def test_trace_reduction():
    st = trace.Stretch()
    trace.reduce_events(spans(), st)
    assert st.lead_in_seen == 3
    assert st.window_s == pytest.approx(1.0e-3)
    assert st.busy_s == pytest.approx((301_000 + 298_995) * 1e-9)
    assert st.ops == 3
    assert st.kernel("k_a") == (2, pytest.approx(498_995e-9))
    idle = st.idle_by_label
    assert idle["simbench.swap > aten::copy_"] == pytest.approx(398_005e-9)
    br = st.breakdown()
    assert set(br) == {"device_ops", "idle_gaps"}
    assert br["device_ops"][0][0] == "k_a"
    assert all(len(x) <= trace.TOP for x in br.values())


def test_trace_needs_the_lead_in():
    with pytest.raises(AssertionError, match="lead-in"):
        trace.reduce_events(spans(lead=0), trace.Stretch())


def test_held_back_readers():
    """The readers of the held-back cells' kernels agree with the entries
    that will bring them back (``simbench.tiny``)."""
    from simbench import tiny

    for m in tiny.HELD_METRICS:
        mod = reader(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == (
            m["unit"], m["layer"], m["moves"], m["source"])


def test_forbidden_modules_compare_whole_names(monkeypatch):
    """The command's last look: ``repro_torch`` is the port, ``flax.core``
    is JAX's."""
    import sys
    import types

    from simbench import cell

    monkeypatch.setitem(sys.modules, "reprox", types.ModuleType("reprox"))
    assert not {"repro_torch", "reprox"} & set(cell.forbidden_modules())
    monkeypatch.setitem(sys.modules, "flax.core",
                        types.ModuleType("flax.core"))
    assert "flax" in cell.forbidden_modules()


def traced_run_data(kernels):
    """A traced run's data on the card, with device kernels ``kernels``."""
    from simbench import cell

    st = trace.Stretch(windows=256, window_s=1.0, busy_s=0.5, ops=300_000,
                       by_name={k: (1024, 0.01) for k in kernels})
    return cell.RunData(stretch=st, counters={"captures": 1, "capture_s":
                                              0.8, "graph_bytes": {"w": 1}},
                        rack=PAPER, points=12)


def test_a_listed_metric_that_reads_nothing_fails_the_run(manifest):
    """A traced run on the card whose trace lacks the kernel a listed
    roofline reads (renamed, or its records lost) is not a result with
    that metric left out."""
    from simbench import cell

    name = "orbitcache-rack.ladder12"
    full = cell.per_layer(manifest, name, traced_run_data(
        ["subround_kernel<12>", "k_a"]), strict=True)
    assert "subround_roofline" in full
    renamed = traced_run_data(["orbit_subround<12>", "k_a"])
    with pytest.raises(cell.MissingMetric, match="subround_roofline"):
        cell.per_layer(manifest, name, renamed, strict=True)
    off_card = cell.per_layer(manifest, name, renamed, strict=False)
    assert set(full) - set(off_card) == {"subround_roofline"}


def test_the_command_exits_1_on_a_missing_metric(monkeypatch, capsys):
    import torch

    from simbench import cell, run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def missing(*args, **kw):
        raise cell.MissingMetric("subround_roofline read nothing")

    monkeypatch.setattr(cell, "run", missing)
    rc = run.main(["--workload", "orbitcache-rack.ladder12", "--seed", "1",
                   "--seconds", "1", "--trace", "1"])
    out = capsys.readouterr()
    assert rc == 1 and out.out.strip() == ""
    assert "subround_roofline" in out.err
