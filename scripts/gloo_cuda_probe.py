"""Which DTensor collectives gloo carries for CUDA tensors, on ranks that
share one card.

NCCL takes one card per rank, so on a one-card machine a multi-rank group
is gloo's.  DTensor's redistributions issue c10d functional collectives
(``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``,
``all_to_all_single``) on the mesh's device.  This script runs each in a
group of its own of 4 gloo ranks (a 2 x 2 mesh), once with CUDA tensors
and once with CPU tensors, checks each rank's piece against the piece of
the whole tensor it should hold, and prints one line a collective and device:
``ok``, ``wrong values``, the error it raised, or the exit code of a rank
that died.  It is a probe: it reports what fails and does not fall
back.

    python scripts/gloo_cuda_probe.py
"""

from __future__ import annotations

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

CASES = {
    # name: (placements before, placements after) on the ("a", "b") mesh
    "all-gather": (("S0", "R"), ("R", "R")),
    "reduce-scatter": (("P", "R"), ("S0", "R")),
    "all-reduce": (("P", "R"), ("R", "R")),
    "all-to-all": (("S0", "R"), ("S1", "R")),
}


def _placement(code: str):
    from torch.distributed.tensor import Partial, Replicate, Shard

    return {"R": Replicate(), "P": Partial(), "S0": Shard(0),
            "S1": Shard(1)}[code]


def probe_rank(rank: int, world: int, device_type: str, name: str) -> str:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    mesh = init_device_mesh(device_type, (2, 2), mesh_dim_names=("a", "b"))
    device = torch.device(device_type, 0) if device_type == "cuda" \
        else torch.device("cpu")
    whole = torch.arange(8 * 8, dtype=torch.float32).reshape(8, 8)
    src, dst = CASES[name]
    if src[0] == "P":
        # Each of the 2 ranks along "a" holds half of the sum.
        local = (whole / 2).to(device)
    else:
        local = whole.chunk(2, 0)[mesh.get_local_rank("a")].to(device)
    x = DTensor.from_local(local, mesh, [_placement(c) for c in src],
                           run_check=False)
    try:
        y = x.redistribute(mesh, [_placement(c) for c in dst])
        got = y.to_local().cpu()
        if device_type == "cuda":
            torch.cuda.synchronize()
        ok = torch.equal(got, _expected(whole, dst, mesh))
        out = "ok" if ok else "wrong values"
    except Exception as e:  # noqa: BLE001 — the probe reports it
        out = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    dist.barrier()
    return out


def _expected(whole, dst, mesh):
    """This rank's piece of ``whole`` under the placements ``dst``."""
    piece = whole
    for i, code in enumerate(dst):
        if code.startswith("S"):
            piece = piece.chunk(mesh.size(i), int(code[1]))[
                mesh.get_local_rank(i)]
    return piece


def main() -> None:
    import torch

    from repro_torch.parallel.spawn import run_ranks

    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    results = {}
    for d in devices:
        for name in CASES:
            try:
                verdict = run_ranks(probe_rank, 4, d, name, timeout_s=120)[0]
            except (RuntimeError, TimeoutError) as e:  # a rank died or hung
                verdict = str(e).splitlines()[0][:160]
            results.setdefault(d, {})[name] = verdict
            print(f"gloo, 4 ranks, {d} tensors: {name}: {verdict}",
                  flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
