"""Per-layer metrics: one reader a file, found by the metric's name.

A reader module holds ``UNIT``, ``LAYER``, ``MOVES`` and ``SOURCE`` (as
``BENCHMARK.json`` lists them) and ``read(run)``, which returns the
metric from the run's trace, spans and counters (:class:`simbench.cell.
RunData`), or ``None`` where it finds nothing to read: the harness then
leaves the metric out of the line off the card, and fails a traced run on
the card in a cell whose manifest entry lists the metric
(:func:`simbench.cell.per_layer`).
"""
from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def reader(name: str):
    """The reader module of metric ``name`` (``metrics/<name>.py``)."""
    path = os.path.join(HERE, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"simbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
