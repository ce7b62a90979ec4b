"""What the benchmark's process may not hold: JAX, its libraries, and the
JAX package this port was made from (``repro``).  Modules are compared by
their whole top-level name, so ``repro_torch`` passes and ``repro.core``
does not."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)
