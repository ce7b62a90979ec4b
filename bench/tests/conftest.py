"""The benchmark's CPU tests import ``bench`` from the checkout's root,
the port from ``src/`` and the port's thread helper from ``tests/``."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src", ROOT / "tests"):
    if str(p) not in sys.path:
        sys.path.append(str(p))
