"""Structured lint findings (port of ``repro.analysis.findings``).

A finding pins one violation to (rule, entry point, op, path into the
recorded trace, user source site), so a failure is actionable without
running anything again.  ``path`` names the body run and the op's place in
it, e.g. ``window[1]/op[812]``, or a carry leaf, e.g. ``carry.clients.tx``.
``severity`` is ``"error"`` (fails the CLI) or ``"warning"`` (printed,
does not fail).
"""
from __future__ import annotations

from dataclasses import dataclass


class Severity:
    ERROR = "error"
    WARNING = "warning"


@dataclass
class Finding:
    rule: str            # registry name, e.g. "no-scatter"
    severity: str        # Severity.ERROR | Severity.WARNING
    entry: str           # entry-point name, e.g. "compiled_controller_chunk"
    message: str         # human-readable statement of the violation
    op: str = ""         # aten op or kernel involved
    path: str = ""       # e.g. "window[1]/op[812]" or "carry.clients.tx"
    site: str = ""       # e.g. "fn @ repro_torch/kvstore/client.py:56"

    def format(self) -> str:
        loc = f" [{self.path}]" if self.path else ""
        at = f" at {self.site}" if self.site else ""
        op = f" ({self.op})" if self.op else ""
        return (f"{self.severity.upper()} {self.rule} {self.entry}{op}: "
                f"{self.message}{at}{loc}")


def errors(findings) -> list:
    return [f for f in findings if f.severity == Severity.ERROR]
