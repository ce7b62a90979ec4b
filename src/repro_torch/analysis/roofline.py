"""Three-term roofline of a traced dry-run step, for the NVIDIA H100 SXM5
(port of ``src/repro/analysis/roofline.py``, whose constants are a TPU
v5e's).

    compute term    = flops_per_device / 989 TFLOP/s
    memory term     = bytes_per_device / 3.35 TB/s
    collective term = collective_bytes_per_device / 50 GB/s

The constants, each per GPU:

* ``PEAK_FLOPS`` 989e12: dense BF16 tensor-core peak of the H100 SXM5
  (NVIDIA H100 Tensor Core GPU datasheet; 1979 TFLOP/s is the 2:4-sparse
  figure).
* ``HBM_BW`` 3.35e12 bytes/s: the H100 SXM5's HBM3 bandwidth (same
  datasheet; ``PERF.md``'s kernel bounds use it too).
* ``LINK_BW`` 50e9 bytes/s: one 400 Gb/s NDR InfiniBand port (ConnectX-7),
  the node network each GPU of a DGX/HGX H100 node of 8 has for itself.
  The 16 x 16 layout's 16-wide ``model`` axis spans two nodes of 8 and its
  ``data`` axis 16 nodes, so every collective of the production meshes
  crosses the node network: that link, not NVLink (``NVLINK_BW``, 450e9
  bytes/s a direction inside a node, NVLink 4's 900 GB/s both ways),
  paces the collective term.

The trace (``analysis.hlo.StepTrace``) counts each rank's *local* work, so
each term divides by one GPU's peak.  These equal the global-sum
formulation total/(chips × peak) exactly when work is evenly sharded —
and when it is not, the per-device view is the correct (slowest-rank)
one.  MODEL_FLOPS uses the 6·N·D rule (2·N·D per token forward-only), so
the useful-compute ratio exposes remat/dispatch/replication overheads.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

PEAK_FLOPS = 989e12          # dense bf16 per GPU
HBM_BW = 3.35e12             # bytes/s per GPU
LINK_BW = 50e9               # bytes/s per GPU, node network (NDR 400 Gb/s)
NVLINK_BW = 450e9            # bytes/s per GPU and direction, inside a node


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_detail: dict
    model_flops: float
    compute_s: float
    memory_s: float
    collective_s: float
    bytes_per_device: dict

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / global traced flops (remat/redundancy waste)."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Ideal model-math time at peak / bound time — the score."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal / self.bound_s if self.bound_s else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, useful_ratio=self.useful_ratio,
                 roofline_fraction=self.roofline_fraction,
                 bound_s=self.bound_s)
        return d


def model_flops(cfg: ModelConfig, shape: dict, kind: str) -> float:
    """6·N_active·D for training, 2·N_active·D for forward-only serving."""
    n = cfg.params_per_token_active()
    if kind == "train":
        tokens = shape["global_batch"] * shape["seq_len"]
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = shape["global_batch"] * shape["seq_len"]
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape["global_batch"]


def analyze(costs: dict, *, arch: str, shape_name: str, shape: dict,
            kind: str, mesh_desc: str, chips: int,
            cfg: ModelConfig) -> Roofline:
    """The roofline of one traced step.  ``costs``: the per-device
    ``flops``, ``bytes``, ``collectives`` (``analysis.hlo.Collective``s)
    and ``bytes_per_device`` of ``launch.dryrun``'s trace."""
    from repro_torch.analysis import hlo as hlolib

    flops, nbytes = float(costs["flops"]), float(costs["bytes"])
    coll = hlolib.collective_bytes(costs["collectives"])
    coll_total = sum(v for k, v in coll.items() if not k.startswith("_"))
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_desc, chips=chips,
        hlo_flops=flops, hlo_bytes=nbytes, coll_bytes=float(coll_total),
        coll_detail=coll, model_flops=model_flops(cfg, shape, kind),
        # The trace counts one device's work → divide by one GPU's peaks.
        compute_s=flops / PEAK_FLOPS,
        memory_s=nbytes / HBM_BW,
        collective_s=coll_total / LINK_BW,
        bytes_per_device=dict(costs["bytes_per_device"]),
    )


def format_row(r: Roofline) -> str:
    return (f"{r.arch:24s} {r.shape:12s} {r.mesh:10s} "
            f"compute={r.compute_s*1e3:9.2f}ms mem={r.memory_s*1e3:9.2f}ms "
            f"coll={r.collective_s*1e3:9.2f}ms dom={r.dominant:10s} "
            f"useful={r.useful_ratio:5.2f} roofline={r.roofline_fraction:5.2%}")
