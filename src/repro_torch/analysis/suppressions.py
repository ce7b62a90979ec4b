"""In-repo waiver list of the fabric verifier.

Port of ``src/repro/analysis/suppressions.py``.

Add a ``Suppression(check=..., path_prefix=..., reason=...)`` here when a
check must be waived — e.g. a known-benign widening while a wire-format
migration is in flight.  Keep the reason honest: it is the review record.
Stale entries (matching no current finding) and entries without a reason
fail ``python -m repro_torch.analysis.lint`` — waivers cannot outlive their
defect.  See README "Verification layer".
"""

from __future__ import annotations

from repro_torch.analysis.diagnostics import Suppression

SUPPRESSIONS: tuple[Suppression, ...] = ()
