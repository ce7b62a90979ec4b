"""The dry-run cases of ``test_torch_dryrun.py``, run in an interpreter of
their own: the dry run's fake process group owns the default group.  Not
a test module: pytest does not collect it.

    python tests/dryrun_cases.py OUT_JSON
"""

from __future__ import annotations

import dataclasses
import json
import sys

SMOKE_SHAPE = dict(seq_len=16, global_batch=8, kind="train")
# The full CLI on a small model at train_4k (meta tensors: nothing is
# allocated at the production shapes).
SMALL = ["n_layers=2", "d_model=64", "n_heads=4", "n_kv_heads=4",
         "d_ff=128", "vocab_size=256", "head_dim=16"]


def smoke_qwen(n_layers=None):
    from repro_torch.configs import get_config, smoke_config

    cfg = smoke_config(get_config("qwen3-8b"))
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def main(out_path: str) -> None:
    import torch
    from torch.distributed.tensor import Shard, Replicate, distribute_tensor

    from repro_torch.analysis import hlo
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_debug_mesh

    out = {}
    for data, model in ((1, 1), (2, 4)):
        with D.fake_group(data * model):
            mesh = make_debug_mesh(data, model, device_type="cpu")
            c = D._cell_costs(smoke_qwen(), SMOKE_SHAPE, mesh)
            out[f"{data}x{model}"] = {k: c[k] for k in
                                      ("flops", "bytes", "coll", "n_ops",
                                       "bytes_per_device")}
            if (data, model) == (2, 4):
                # An evenly sharded matmul: batch on data, features on
                # model.
                x = distribute_tensor(torch.empty(64, 32, 48,
                                                  device="meta"), mesh,
                                      [Shard(0), Replicate()])
                w = distribute_tensor(torch.empty(48, 96, device="meta"),
                                      mesh, [Replicate(), Shard(1)])
                with hlo.StepTrace() as t:
                    x @ w
                out["matmul"] = {"flops": t.flops,
                                 "global": 2 * 64 * 32 * 48 * 96,
                                 "collectives": len(t.collectives)}
            deep = smoke_qwen(6)
            full = D._cell_costs(deep, SMOKE_SHAPE, mesh)
            ext = D.extrapolated_costs(deep, SMOKE_SHAPE, mesh)
            out[f"deep_{data}x{model}"] = {
                "full": {k: full[k] for k in ("flops", "bytes", "coll")},
                "extrapolated": {k: ext[k] for k in ("flops", "bytes",
                                                     "coll")}}
    cli_out = out_path + ".cli.json"
    D.main(["--arch", "qwen3-8b", "--shape", "train_4k", "--device", "cpu",
            "--out", cli_out, "--no-probes", "--set", *SMALL])
    with open(cli_out) as f:
        out["cli"] = json.load(f)
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
