"""Diagnostic records and the suppression mechanism of the fabric verifier.

Port of ``src/repro/analysis/diagnostics.py``.  Every pass (``planlint``,
``programlint``, ``kernelcheck``) reports findings
as ``Diagnostic`` values — a stable check id, the path of the offending
object (scenario/level/edge, program/eqn, kernel/grid cell), and a message.
A check that must be waived gets a ``Suppression`` in
``repro_torch.analysis.suppressions``; suppressions are themselves linted —
one that no longer matches anything is *stale* and fails the run, so
waivers cannot outlive the defect they excuse.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One verifier finding.

    ``check`` is the stable id (``plan.merge-segments``, ``program.f64``,
    ``kernel.scatter-overlap``, ...); ``path`` locates the offending object
    (``EXT_4CASE_96CHIP/1dead_uplink/level[1]/edge[0]``).
    """

    check: str
    path: str
    message: str
    severity: str = ERROR

    def format(self) -> str:
        return f"{self.severity}: {self.check} @ {self.path}: {self.message}"


@dataclasses.dataclass(frozen=True)
class Suppression:
    """Waives diagnostics of one check under a path prefix.

    ``reason`` is mandatory documentation, the record of why the check
    is waived in ``suppressions.py``; the linter only requires it to be
    non-empty.
    """

    check: str
    path_prefix: str = ""
    reason: str = ""

    def matches(self, diag: Diagnostic) -> bool:
        return (diag.check == self.check
                and diag.path.startswith(self.path_prefix))


def apply_suppressions(
    diags: Iterable[Diagnostic], suppressions: Sequence[Suppression]
) -> tuple[list[Diagnostic], list[Diagnostic]]:
    """Split findings into (active, suppressed) and lint the waiver list.

    Appends to *active*: one ``suppression.stale`` error per suppression
    that matched nothing (the defect it excused is gone — delete it) and
    one ``suppression.undocumented`` error per suppression without a
    reason.
    """
    diags = list(diags)
    active: list[Diagnostic] = []
    suppressed: list[Diagnostic] = []
    hits = [0] * len(suppressions)
    for d in diags:
        for i, s in enumerate(suppressions):
            if s.matches(d):
                hits[i] += 1
                suppressed.append(d)
                break
        else:
            active.append(d)
    for i, s in enumerate(suppressions):
        where = f"suppressions[{i}]"
        if not s.reason.strip():
            active.append(Diagnostic(
                "suppression.undocumented", where,
                f"suppression of {s.check!r} has no reason"))
        if hits[i] == 0:
            active.append(Diagnostic(
                "suppression.stale", where,
                f"suppression of {s.check!r} (prefix {s.path_prefix!r}) "
                "matched no finding — the waived defect is gone, delete it"))
    return active, suppressed


def worst_severity(diags: Iterable[Diagnostic]) -> str | None:
    sevs = {d.severity for d in diags}
    if ERROR in sevs:
        return ERROR
    if WARNING in sevs:
        return WARNING
    return None
