"""No module the benchmark loads has the top-level name ``jax``,
``jaxlib``, ``flax`` or ``repro`` (the JAX package): ``repro_torch``,
the port, is allowed.  Checked in a fresh process that runs a cell."""

import json
import pathlib
import subprocess
import sys

from bench.lib import guard

ROOT = pathlib.Path(__file__).resolve().parents[2]

SCRIPT = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from bench.tests import tiny
line = tiny.run("ext4case.engine")
from bench.lib import guard
print(json.dumps({{"correct": line["correct"],
                  "forbidden": guard.forbidden_modules(),
                  "port": "repro_torch" in sys.modules}}))
"""


def test_top_level_names_are_compared_whole():
    assert guard.forbidden_modules(["repro_torch", "repro_torch.snn",
                                    "reprocess", "jaxtyping"]) == []
    assert guard.forbidden_modules(["repro", "repro.core", "jax.numpy",
                                    "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]


def test_a_run_loads_no_jax_and_no_repro(tmp_path):
    code = SCRIPT.format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2",
                              "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"correct": True, "forbidden": [], "port": True}


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         "fullbp.sweep", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
