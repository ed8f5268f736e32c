"""Structural checks of the port (counterpart of ``repro.analysis``).

The architecture's load-bearing guarantees, machine-checked on the CPU
and on the card:

  * :mod:`.op_trace`     — the dispatch-mode recorder of a body's ops
    (op, dtypes, devices, body run, user site);
  * :mod:`.profile`      — op counts of a recording; on the card, the
    kernels and host/device copies ``torch.profiler`` sees;
  * :mod:`.rules`        — the rule registry and per-rule allowlists;
  * :mod:`.entry_points` — the six production entry points the linter
    covers, and their expected kernel calls;
  * :mod:`.fixtures`     — a seeded violation and its clean twin per rule;
  * :mod:`.invariants`   — the post-window structural invariants of a
    state, as library checks;
  * :mod:`.lint`         — ``run_lint`` and the ``python -m
    repro_torch.analysis.lint`` CLI (not imported here, so that ``-m``
    runs it fresh).

See ``src/repro_torch/analysis/README.md`` for each rule's rationale and
every allowlist entry.
"""
from .findings import Finding, Severity, errors
from .op_trace import OpRecorder, trace
from .rules import ALLOWLISTS, RULES

__all__ = [
    "ALLOWLISTS",
    "Finding",
    "OpRecorder",
    "RULES",
    "Severity",
    "errors",
    "trace",
]
