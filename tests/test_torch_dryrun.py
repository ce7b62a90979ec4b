"""The port's dry run (``repro_torch.launch.dryrun``), its collective
record (``analysis.hlo``) and its H100 roofline (``analysis.roofline``).

The fake process group owns the default group, so the traces run in one
interpreter of their own (``dryrun_cases.py``), started once for the
module:

* a qwen3-8b smoke train step traced on a 1 x 1 mesh counts as many flops
  as ``FlopCounterMode`` counts for the same step run for real on the CPU
  (equal);
* on a 2 x 4 fake mesh each device counts at least its 1/8 share of those
  flops and less than a 1/4 share (DTensor repeats some matmul work on the
  model axis: the replicated share); an evenly sharded matmul counts
  exactly global / 8;
* ``extrapolated_costs`` (the reference's shallow probes) equals the
  full-depth trace of a 6-layer model;
* the CLI writes a roofline record.

Without a group: ``collective_bytes`` of the records of the reference's
``test_hlo_collective_parser`` collectives equals its parser's figures on
its HLO text; ``model_flops`` and ``probe_configs`` equal the reference's
for the ten archs.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import dryrun_cases as dc
from repro.analysis import hlo as jhlo
from repro.analysis import roofline as jroof
from repro.configs import get_config as jget_config
from repro.launch import dryrun as jdryrun
from repro_torch.analysis import hlo
from repro_torch.analysis import roofline as rl
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.shapes import SHAPES
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import make_train_step
from torch_threads import share_cores

share_cores()

HLO_TEXT = """
  %ag = bf16[8,512] all-gather(%p0), replica_groups={}
  %ar.1 = f32[128] all-reduce(%x), to_apply=%sum
  %tup = (f32[64], f32[32]) all-to-all(%a, %b)
  %cp = u32[16] collective-permute(%c)
"""


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "cases.json"
    here = os.path.dirname(__file__)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(here, "..", "src"), here,
         os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, os.path.join(here,
                                                        "dryrun_cases.py"),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def real_flops() -> int:
    """FlopCounterMode's count of the smoke step run for real on the CPU."""
    cfg = dc.smoke_qwen()
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    b, s = dc.SMOKE_SHAPE["global_batch"], dc.SMOKE_SHAPE["seq_len"]
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s + 1),
                                     dtype=torch.int32)}
    step = make_train_step(cfg, adamw.AdamWConfig(), device="cpu")
    with FlopCounterMode(display=False) as fc:
        step(params, adamw.init(params), batch)
    return fc.get_total_flops()


def test_smoke_cell_traces_on_one_device(traced):
    one = traced["1x1"]
    assert one["flops"] > 0 and one["bytes"] > 0
    assert one["coll"] == 0                      # one device: no wire
    assert one["flops"] == real_flops()
    mem = one["bytes_per_device"]
    assert mem["arguments"] > 0 and mem["temps"] > 0
    assert mem["total_live"] == (mem["arguments"] + mem["outputs"]
                                 + mem["temps"] - mem["aliased"])


def test_flops_per_device_on_a_fake_mesh(traced):
    one, eight = traced["1x1"]["flops"], traced["2x4"]["flops"]
    assert one / 8 <= eight < one / 4
    assert traced["2x4"]["coll"] > 0
    mm = traced["matmul"]
    assert mm["flops"] * 8 == mm["global"] and mm["collectives"] == 0


@pytest.mark.parametrize("mesh", ["1x1", "2x4"])
def test_extrapolation_equals_full_depth(traced, mesh):
    r = traced[f"deep_{mesh}"]
    for k in ("flops", "bytes", "coll"):
        assert r["extrapolated"][k] == pytest.approx(r["full"][k],
                                                     rel=1e-9), k


def test_cli_record(traced):
    rec = traced["cli"]["qwen3-8b|train_4k|16x16"]
    assert rec["status"] == "ok" and rec["kind"] == "train"
    roof = rec["roofline"]
    assert roof["chips"] == 256 and roof["hlo_flops"] > 0
    assert roof["coll_bytes"] > 0 and rec["collective_schedule"]
    assert set(roof["bytes_per_device"]) == {
        "arguments", "outputs", "temps", "aliased", "total_live"}
    assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"],
                                  roof["collective_s"])
    assert rec["overrides"]["n_layers"] == 2


def test_collective_bytes_match_hlo_parser():
    records = [hlo.Collective("all-gather", ((torch.bfloat16, (8, 512)),)),
               hlo.Collective("all-reduce", ((torch.float32, (128,)),)),
               hlo.Collective("all-to-all", ((torch.float32, (64,)),
                                             (torch.float32, (32,)))),
               hlo.Collective("collective-permute",
                              ((torch.uint32, (16,)),))]
    assert hlo.collective_bytes(records) == jhlo.collective_bytes(HLO_TEXT)
    assert hlo.total_collective_bytes(records) == \
        jhlo.total_collective_bytes(HLO_TEXT)
    assert hlo.COLLECTIVE_OPS == jhlo.COLLECTIVE_OPS
    assert hlo.collective_schedule(records, limit=2) == [
        "all-gather: bfloat16[8,512]", "all-reduce: float32[128]"]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_and_probes_match_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in SHAPES.items():
        assert rl.model_flops(cfg, shape, shape["kind"]) == \
            jroof.model_flops(jcfg, shape, shape["kind"]), name
    got, want = D.probe_configs(cfg), jdryrun.probe_configs(jcfg)
    for g, w in zip(got, want):
        if dataclasses.is_dataclass(g):
            assert dataclasses.asdict(g) == dataclasses.asdict(w)
        else:
            assert g == w


def test_roofline_terms():
    cfg = get_config("smollm-135m")
    shape = SHAPES["train_4k"]
    costs = {"flops": 989e12, "bytes": 3.35e12 / 2,
             "collectives": [hlo.Collective(
                 "all-reduce", ((torch.float32, (25_000_000_000,)),))],
             "bytes_per_device": {}}
    r = rl.analyze(costs, arch="smollm-135m", shape_name="train_4k",
                   shape=shape, kind="train", mesh_desc="16x16", chips=256,
                   cfg=cfg)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(0.5)
    assert r.collective_s == pytest.approx(2.0)
    assert r.dominant == "collective" and r.bound_s == pytest.approx(2.0)
    assert "collective" in rl.format_row(r)
