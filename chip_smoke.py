"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. Environment: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the build of the CUDA kernels from
   ``src/repro_torch/kernels/**/csrc`` into ``build/repro_torch/`` (one
   ``nvcc`` per source, all at once).
2. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and in every variant: the exchange kernels bit-exact, the
   LM kernels within a stated tolerance; device time per launch (CUDA-graph
   replay), the plain version's time, a library call's time where one
   computes the same function, and the bound.
3. The SNN main path at full width (512 neurons x 256 rows per chip, batch
   8, 64 steps): ``run_stream`` on FULL_BACKPLANE (untimed gather: the
   exchange kernel), EXT_4CASE_96CHIP (timed, gather and routed) and
   PROJECTED_120CHIP (timed), with each kernel's launch count checked.
4. The port on the card against the port on the CPU: same network, dyadic
   weights and drives, 16 steps; integer outputs equal up to near-threshold
   spike flips (``repro_torch.parity``), the exchange stage bit-exact under
   teacher forcing.
5. The LM main path: zamba2-7b at full width and depth (81 layers, random
   weights from a seed, float32 parameters, bf16 activations,
   ``attention_impl="pallas"``) serving batch 4 x prompt 2048 with 32 greedy
   new tokens through ``repro_torch.launch.serve.generate``; prefill time,
   decode tokens/s, peak device memory, each kernel's launch count checked
   (13 flash-attention and 81 linear-scan launches per prefill, two
   prefills with the warm pass), and a profiler pass over one prefill and
   one decode step.
6. The LM on the card against the CPU: the same converted weights at full
   width, 7 layers, float32, batch 2 x prompt 64; prefill and decode-step
   logits within a stated tolerance, and the 4 greedy tokens equal.

Any failure exits non-zero.  The last line is the result for the harness.
It needs the repository's ``src/`` beside it and a CUDA device; without
either it fails before printing a result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch import convert, parity  # noqa: E402
from repro_torch.analysis import scenarios  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import fabric as fablib  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.linear_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.linear_scan.ref import linear_scan_chunked  # noqa: E402
from repro_torch.kernels.spike_router import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.snn import network as netlib  # noqa: E402
from repro_torch.snn import stream  # noqa: E402
from repro_torch.core.latency import timed_wire  # noqa: E402

DEV = torch.device("cuda")
BATCH, STEPS, CHECK_STEPS, PROFILE_STEPS = 8, 64, 16, 8
# Each synapse row receives an external spike with this probability per
# step: on the feed-forward network it puts the neurons' spike occupancy
# near the catalogue's 5% headline (measured and printed in phase 3).
DRIVE_P = 0.035
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
OPS_PER_S = 67e12                # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM bf16 tensor cores, dense
KERNEL_SOURCES = {
    "merge_pack": ("src/repro_torch/kernels/spike_router/csrc/merge_pack.cu",
                   "src/repro/kernels/spike_router/spike_router.py:498"),
    "exchange": ("src/repro_torch/kernels/spike_router/csrc/exchange.cu",
                 "src/repro/kernels/spike_router/spike_router.py:379"),
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:129"),
    "linear_scan": ("src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu",
                    "src/repro/kernels/linear_scan/linear_scan.py:106"),
}
# The LM main path (phase 5) and the card-against-CPU check (phase 6).
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32
CHECK_LAYERS, CHECK_BATCH, CHECK_PROMPT, CHECK_NEW = 7, 2, 64, 4
# Phase 6: float32 on both sides; cuBLAS and the two kernels sum in another
# order than the CPU's BLAS and the plain versions, over 7 layers of width
# 3584 (logits are about 1 in size).
CHECK_LOGIT_TOL = 1e-3
# Main-path runs of phase 3: (scenario, exchange mode, timed).
MAIN_PATHS = (("FULL_BACKPLANE", "gather", False),
              ("EXT_4CASE_96CHIP", "gather", True),
              ("EXT_4CASE_96CHIP", "routed", True),
              ("PROJECTED_120CHIP", "gather", True))
CHECK_PATHS = (("FULL_BACKPLANE", "gather", False),
               ("EXT_4CASE_96CHIP", "gather", True),
               ("PROJECTED_120CHIP", "routed", True))


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def graph_ms(fn, launches: int = 50, replays: int = 20) -> float:
    """Device time per call: ``launches`` calls captured in one CUDA graph,
    replayed, timed with CUDA events (host overhead excluded)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def eager_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time per call as called (host overhead included), CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: int, ops_done: int,
          ops_per_s: float = OPS_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops_done / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(outs_a, outs_b) -> float:
    err = 0.0
    for a, b in zip(outs_a, outs_b, strict=True):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{a.dtype}{tuple(a.shape)} vs "
                                 f"{b.dtype}{tuple(b.shape)}")
        if a.numel():
            err = max(err, float((a.long() - b.long()).abs().max()))
    return err


# ---------------------------------------------------------------------------
# Phase 2 inputs: synthetic streams at the main path's shapes
# ---------------------------------------------------------------------------


def lut(gen, n: int, size: int, enable_bit: int, payload_bits: int):
    """Random LUTs, ~15% of entries disabled."""
    payload = torch.randint(0, 1 << payload_bits, (n, size), generator=gen,
                            device=DEV, dtype=torch.int32)
    en = (torch.rand((n, size), generator=gen, device=DEV) < 0.85)
    return payload | (en.to(torch.int32) << enable_bit)


def merge_case(gen, rows, seg_lens, n_tables, wire16, timed, compact, occ):
    """Front-compacted segments (count ~ Binomial(len, occ), every 7th row
    dense so it overflows), or independent slots when not compact."""
    n = sum(seg_lens)
    occ_row = torch.full((rows, 1), occ, device=DEV)
    occ_row[::7] = 0.9
    if compact:
        parts = []
        for s in seg_lens:
            k = (torch.rand((rows, s), generator=gen, device=DEV)
                 < occ_row).sum(-1, keepdim=True)
            parts.append(torch.arange(s, device=DEV)[None] < k)
        valid = torch.cat(parts, dim=-1)
    else:
        valid = torch.rand((rows, n), generator=gen, device=DEV) < occ_row
    labels = torch.randint(0, 1 << 15, (rows, n), generator=gen, device=DEV,
                           dtype=torch.int32)
    if wire16:
        # Validity rides the words; the caller's mask is the enable lane.
        labels = torch.where(valid, labels | (1 << 15), 0).to(torch.int16)
        valid = torch.ones_like(valid)
    rev = lut(gen, n_tables, 1 << 15, 16, 16)
    kw = dict(capacity=None, seg_lens=seg_lens, compact=compact)
    if timed:
        kw["times"] = torch.randint(0, 4000, (rows, n), generator=gen,
                                    device=DEV, dtype=torch.int32)
        kw["queue"] = timed_wire().queue
    return (labels, valid, rev if n_tables > 1 else rev[0]), kw


def merge_cost(args, kw, outs) -> tuple[int, int]:
    """Bytes the merge must move (inputs read once, the rev entries of the
    kept events only, outputs written once) and its integer operations
    (about ten per input slot and per output slot)."""
    labels, valid, _ = args
    kept = int(outs[1].sum())
    nbytes = (labels.numel() * labels.element_size() + valid.numel()
              + 4 * kept + sum(o.numel() * o.element_size() for o in outs))
    if kw.get("times") is not None:
        nbytes += kw["times"].numel() * 4
    return nbytes, 10 * (labels.numel() + outs[0].numel())


def phase2(results: dict) -> None:
    gen = torch.Generator(device=DEV).manual_seed(2)
    plans = {name: scenarios.engine_network(name, device="cpu")[::2]
             for name, *_ in scenarios.CASES}

    def shape_of(name, mode):
        cfg, plan = plans[name]
        plan = fablib.with_exchange_mode(plan, mode)
        return cfg.n_chips * BATCH, fablib.merge_segments(plan, cfg.capacity), \
            cfg.capacity, cfg.n_chips

    # (variant, scenario, mode, wire16, per-row tables, timed, compact)
    variants = (
        ("ext_gather_timed", "EXT_4CASE_96CHIP", "gather", False, True, True,
         True),
        ("ext_routed_timed_wire16", "EXT_4CASE_96CHIP", "routed", True, True,
         True, True),
        ("proj_gather_timed", "PROJECTED_120CHIP", "gather", False, True,
         True, True),
        ("proj_routed_untimed_wire16", "PROJECTED_120CHIP", "routed", True,
         True, False, True),
        ("full_gather_timed_uniform", "FULL_BACKPLANE", "gather", False,
         True, True, False),
        ("ext_gather_shared_rev_global", "EXT_4CASE_96CHIP", "gather", False,
         False, False, False),
        ("ext_routed_shared_rev_wire16_global", "EXT_4CASE_96CHIP", "routed",
         True, False, False, False),
    )
    err = 0.0
    main_case = None
    for name, scen, mode, wire16, per_row, timed, compact in variants:
        rows, segs, cap, n_tables = shape_of(scen, mode)
        args, kw = merge_case(gen, rows, segs, n_tables if per_row else 1,
                              wire16, timed, compact, 0.05)
        kw["capacity"] = cap
        if not compact:
            kw["seg_lens"] = None if "global" in name else segs
        got = ops.fused_merge_pack(*args, **kw)
        want = ref.merge_pack_ref(*args, **kw)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        if e:
            raise AssertionError(f"merge_pack {name}: kernel != plain "
                                 f"(max abs err {e})")
        err = max(err, e)
        ms = graph_ms(lambda: ops.fused_merge_pack(*args, **kw))
        nbytes, nops = merge_cost(args, kw, got)
        b_ms, b_by = bound(nbytes, nops)
        print(f"phase 2: merge_pack {name}: rows {rows} x {sum(segs)} "
              f"events -> cap {cap}, dropped {int(got[-1].sum())}, exact; "
              f"kernel {ms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us "
              f"({b_by})", flush=True)
        if name == "ext_gather_timed":
            main_case = (args, kw, ms, b_ms, b_by)
    args, kw, ms, b_ms, b_by = main_case
    results["merge_pack"] = dict(
        max_abs_err=err, ms=ms,
        plain_ms=eager_ms(lambda: ref.merge_pack_ref(*args, **kw)),
        eager_ms=eager_ms(lambda: ops.fused_merge_pack(*args, **kw)),
        bound_ms=b_ms, bound_by=b_by)

    # The exchange kernel: FULL_BACKPLANE's shape (batch x 12 sources x 256
    # egress slots, capacity 256), identity-like tables and all-to-all
    # enables as on the main path, then random tables, random enables and
    # dense traffic so destinations overflow.
    cfg, plan = plans["FULL_BACKPLANE"]
    n, cap = cfg.n_chips, cfg.capacity
    err = 0.0
    main_case = None
    for name, occ, random_luts in (("main_path_tables", 0.05, False),
                                   ("random_tables_overflow", 0.6, True)):
        labels = ((torch.arange(n, device=DEV, dtype=torch.int32)[:, None]
                   << 9) + torch.randint(0, 512, (BATCH, n, cap),
                                         generator=gen, device=DEV,
                                         dtype=torch.int32))
        valid = torch.rand((BATCH, n, cap), generator=gen, device=DEV) < occ
        if random_luts:
            fwd = lut(gen, n, 1 << 16, 15, 15)
            rev = lut(gen, n, 1 << 15, 16, 16)
            enables = torch.rand((n, n), generator=gen, device=DEV) < 0.7
        else:
            params = netlib.to_device(
                scenarios.engine_network("FULL_BACKPLANE", device="cpu")[1],
                DEV)
            fwd, rev = params.router.fwd_tables, params.router.rev_tables
            enables = torch.from_numpy(plan.levels[0].enables).to(DEV)
        args = (labels, valid, fwd, rev, enables)
        got = ops.fused_exchange(*args, capacity=cap)
        want = ref.exchange_ref(*args, capacity=cap)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        if e:
            raise AssertionError(f"exchange {name}: kernel != plain "
                                 f"(max abs err {e})")
        err = max(err, e)
        ms = graph_ms(lambda: ops.fused_exchange(*args, capacity=cap))
        # Bytes: frames read once, the fwd entries of the valid events, the
        # enables, the rev entries of the kept events, outputs written once.
        nbytes = (labels.numel() * 5 + 4 * int(valid.sum()) + enables.numel()
                  + 4 * int(got[1].sum())
                  + sum(o.numel() * o.element_size() for o in got))
        nops = 10 * (labels.numel() * n + got[0].numel())
        b_ms, b_by = bound(nbytes, nops)
        print(f"phase 2: exchange {name}: {BATCH} x {n} x {cap} -> cap "
              f"{cap}, dropped {int(got[2].sum())}, exact; kernel "
              f"{ms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by})",
              flush=True)
        if main_case is None:
            main_case = (args, ms, b_ms, b_by)
    args, ms, b_ms, b_by = main_case
    results["exchange"] = dict(
        max_abs_err=err, ms=ms,
        plain_ms=eager_ms(lambda: ref.exchange_ref(*args, capacity=cap)),
        eager_ms=eager_ms(lambda: ops.fused_exchange(*args, capacity=cap)),
        bound_ms=b_ms, bound_by=b_by)
    for k, r in results.items():
        print(f"phase 2: {k}: kernel {r['ms'] * 1e3:.2f} us (graph replay), "
              f"{r['eager_ms'] * 1e3:.2f} us as called, plain "
              f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.3f}"
              f" us ({r['bound_by']})", flush=True)


# ---------------------------------------------------------------------------
# Phase 2, LM kernels: flash attention and the linear scan
# ---------------------------------------------------------------------------

# One bf16 ulp, relative: both sides round an f32 result to bf16.
BF16_ULP = 2.0 ** -7


def check_close(what: str, got, want, rel: float, abs_tol: float,
                reason: str) -> float:
    """Elementwise |got - want| <= rel·|want| + abs_tol, finite; prints the
    max abs error beside the tolerance and its reason, raises if exceeded."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = float(diff.max())
    excess = float((diff - rel * want.abs()).max())
    ok = bool(torch.isfinite(got).all()) and excess <= abs_tol
    print(f"phase 2: {what}: max abs err {err:.3g} (max |ref| "
          f"{float(want.abs().max()):.3g}); tolerance |err| <= {rel:.3g}"
          f"·|ref| + {abs_tol:.3g}: {reason}: {'ok' if ok else 'EXCEEDED'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{what}: kernel != plain (max abs err {err}, "
                             f"excess {excess} over {abs_tol})")
    return err


def unique_bytes(t: torch.Tensor) -> int:
    """Bytes a function must read of ``t``: its distinct elements (a
    broadcast view's stride-0 dims count once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def flash_inputs(gen, b, hq, hkv, s, d, dtype):
    def rnd(h):
        return torch.randn((b, h, s, d), generator=gen, device=DEV).to(dtype)
    return rnd(hq), rnd(hkv), rnd(hkv)


def mamba_inputs(gen, b, h, t, st, hd, dtype):
    """The scan's operands as ``mamba2_forward`` builds them at zamba2's
    shapes: q = C and k = dt·B shared by the heads (q a stride-0 view),
    v = x per head, w = dt·a a float32 view shared by the K channels, with
    zamba2's decay rates a = -linspace(1, 16)."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=DEV)
    x = F.silu(rnd(b, t, h * hd)).to(dtype)
    b_mat = F.silu(rnd(b, t, st)).to(dtype)
    c_mat = F.silu(rnd(b, t, st)).to(dtype)
    dt = F.softplus(rnd(b, t, h))
    a = -torch.linspace(1.0, 16.0, h, device=DEV)
    w = (dt * a).transpose(1, 2)[..., None].expand(b, h, t, st)
    q = c_mat[:, None].expand(b, h, t, st)
    k = b_mat[:, None].expand(b, h, t, st) \
        * dt.transpose(1, 2)[..., None].to(dtype)
    v = x.reshape(b, t, h, hd).transpose(1, 2)
    return q, k, v, w, None


def rwkv_inputs(gen, b, h, t, kd, dtype):
    """Bonus-mode operands at RWKV6's shapes: per-channel data-dependent
    decays w = -exp(base + noise), base from -6 to -0.5 across channels,
    and a bonus u."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=DEV)
    base = torch.linspace(-6.0, -0.5, h * kd, device=DEV).reshape(h, kd)
    w = -torch.exp(base[None, :, None, :] + 0.5 * rnd(b, h, t, kd))
    return (rnd(b, h, t, kd).to(dtype), (0.5 * rnd(b, h, t, kd)).to(dtype),
            rnd(b, h, t, kd).to(dtype), w, 0.5 * rnd(h, kd))


def phase2_lm(results: dict) -> None:
    gen = torch.Generator(device=DEV).manual_seed(7)
    bf16, f32 = torch.bfloat16, torch.float32
    f32_reason = "float32 sums in another order than the plain version"
    bf16_reason = ("bf16 output, one ulp apart where the two f32 results "
                   "round apart")

    # Flash attention.  (case, (b, hq, hkv, s, d, dtype), causal, tolerance)
    flash_cases = (
        ("main path: b4 h32 s2048 d112 bf16 causal",
         (4, 32, 32, 2048, 112, bf16), True, (BF16_ULP, 1e-5, bf16_reason)),
        ("GQA group 4: b2 h32/8 s1024 d128 bf16 causal",
         (2, 32, 8, 1024, 128, bf16), True, (BF16_ULP, 1e-5, bf16_reason)),
        ("ragged s2000: b1 h8 d112 bf16 causal", (1, 8, 8, 2000, 112, bf16),
         True, (BF16_ULP, 1e-5, bf16_reason)),
        ("f32: b2 h8 s1024 d112 causal", (2, 8, 8, 1024, 112, f32), True,
         (0.0, 2e-5, f32_reason)),
        ("f32: b1 h4/2 s1000 d64 not causal", (1, 4, 2, 1000, 64, f32), False,
         (0.0, 2e-5, f32_reason)),
    )
    err = 0.0
    for i, (name, shape, causal, tol) in enumerate(flash_cases):
        q, k, v = flash_inputs(gen, *shape)
        got = flash_ops.flash_attention(q, k, v, causal=causal)
        want = attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = max(err, check_close(f"flash_attention {name}", got, want,
                                   *tol))
        if i == 0:
            main = (q, k, v)
        del q, k, v, got, want
    q, k, v = main
    b, h, s, d = q.shape
    scale = 1.0 / d ** 0.5
    # Bytes: q, k, v read once, the output written once; operations: the
    # two products over the causal half (keys at or before each query).
    nbytes = 4 * q.numel() * q.element_size()
    nops = 4 * b * h * d * (s * (s + 1) // 2)
    b_ms, b_by = bound(nbytes, nops, BF16_OPS_PER_S)
    results["flash_attention"] = dict(
        max_abs_err=err,
        ms=graph_ms(lambda: flash_ops.flash_attention(q, k, v), 5, 2),
        plain_ms=eager_ms(lambda: attention_ref(q, k, v), 2, 1),
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True), 5, 2),
        bound_ms=b_ms, bound_by=b_by)
    del main, q, k, v

    # Linear scan.  (case, make inputs, mode, tolerance)
    scan_reason = ("bf16 output one ulp apart, and __expf and float32 sums "
                   "and cumsums in another order (1e-3 of the output's scale)")
    scan_cases = (
        ("main path: mamba2 b4 h112 t2048 k64 v64 bf16 inclusive",
         lambda: mamba_inputs(gen, 4, 112, 2048, 64, 64, bf16), "inclusive",
         (BF16_ULP, 1e-3, scan_reason)),
        ("bonus: rwkv6 b2 h64 t1024 k64 v64 bf16",
         lambda: rwkv_inputs(gen, 2, 64, 1024, 64, bf16), "bonus",
         (BF16_ULP, 1e-3, scan_reason)),
        ("ragged t1000: mamba2 b2 h16 bf16 inclusive",
         lambda: mamba_inputs(gen, 2, 16, 1000, 64, 64, bf16), "inclusive",
         (BF16_ULP, 1e-3, scan_reason)),
        ("strong decays up to e^-10 per step: b1 h8 t512 f32 inclusive",
         lambda: (*(torch.randn((1, 8, 512, 64), generator=gen, device=DEV)
                    for _ in range(3)),
                  -10 * torch.rand((1, 8, 512, 64), generator=gen,
                                   device=DEV), None),
         "inclusive", (0.0, 1e-3, "__expf and float32 cumsums in another "
                       "order at |b| ~ 300 (1e-3 of the output's scale)")),
    )
    err = 0.0
    for i, (name, make, mode, (rel, abs_rel, reason)) in enumerate(scan_cases):
        args = make()
        got = scan_ops.linear_scan(*args, mode=mode)
        chunk = scan_ops.chunk_for(args[0].shape[2])
        want = linear_scan_chunked(*args, mode=mode, chunk=chunk).to(got.dtype)
        torch.cuda.synchronize()
        abs_tol = abs_rel * float(want.float().abs().max())
        err = max(err, check_close(f"linear_scan {name}", got, want, rel,
                                   abs_tol, reason))
        if i == 0:
            main = args
        del args, got, want
    q, k, v, w, _ = main
    kdim, vdim = q.shape[-1], v.shape[-1]
    bsz, heads, t = q.shape[:3]
    chunk = scan_ops.chunk_for(t)
    # Bytes: the distinct bytes of q, k, v, w read once and y written once.
    # Operations: the chunked form's multiply-adds per chunk (inter-chunk
    # and carry products, and the causal half of A and of A @ V).
    nbytes = (sum(map(unique_bytes, (q, k, v, w)))
              + v.numel() * q.element_size())
    per_chunk = 2 * (2 * chunk * kdim * vdim
                     + chunk * (chunk + 1) // 2 * (kdim + vdim))
    nops = bsz * heads * (t // chunk) * per_chunk
    b_ms, b_by = bound(nbytes, nops, BF16_OPS_PER_S)
    results["linear_scan"] = dict(
        max_abs_err=err,
        ms=graph_ms(lambda: scan_ops.linear_scan(q, k, v, w), 5, 2),
        plain_ms=eager_ms(lambda: linear_scan_chunked(q, k, v, w,
                                                      chunk=chunk), 2, 1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    del main, q, k, v, w
    for name in ("flash_attention", "linear_scan"):
        r = results[name]
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"phase 2: {name} main-path shape: kernel {r['ms']:.4f} ms "
              f"(graph replay), plain {r['plain_ms']:.4f} ms, library {lib}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 3: the main path at full width
# ---------------------------------------------------------------------------


def phase3(launches: dict, gpu: str) -> None:
    for name, mode, timed in MAIN_PATHS:
        cfg, params, plan = scenarios.engine_network(name, device=DEV)
        plan = fablib.with_exchange_mode(plan, mode)
        state = netlib.init_state(cfg, BATCH, device=DEV)
        gen = torch.Generator(device=DEV).manual_seed(3)
        drives = (torch.rand((STEPS, cfg.n_chips, BATCH, cfg.chip.n_rows),
                             generator=gen, device=DEV)
                  < DRIVE_P).to(torch.float32)
        stream.run_stream(params, state, drives[:4], cfg, fabric=plan,
                          timed=timed, device=DEV)            # warm-up
        torch.cuda.synchronize()
        ops.fused_merge_pack.launches = 0
        ops.fused_exchange.launches = 0
        t0 = time.perf_counter()
        out = stream.run_stream(params, state, drives, cfg, fabric=plan,
                                timed=timed, device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"merge_pack": ops.fused_merge_pack.launches,
                  "exchange": ops.fused_exchange.launches}
        one_level = plan.n_levels == 1 and not timed and mode == "gather"
        want = {"exchange": STEPS if one_level else 0,
                "merge_pack": 0 if one_level else STEPS}
        if counts != want:
            raise AssertionError(f"{name}/{mode}: launches {counts}, "
                                 f"expected {want}")
        for k, v in counts.items():
            launches[k] += v
        spikes = int(out.spikes.sum())
        if spikes == 0:
            raise AssertionError(f"{name}/{mode}: no spikes")
        for f in ("dropped", "uplink_dropped", "latency_ns"):
            x = getattr(out, f)
            if x.dtype != torch.int32:
                raise AssertionError(f"{f} is {x.dtype}")
        line = (f"phase 3: {name}/{mode}/{'timed' if timed else 'untimed'}: "
                f"{cfg.n_chips} chips x {cfg.chip.n_neurons} neurons x "
                f"{cfg.chip.n_rows} rows, batch {BATCH}, {STEPS} steps in "
                f"{wall:.3f} s = {STEPS / wall:.1f} steps/s, "
                f"{spikes / wall:.4g} egress events/s, spike occupancy "
                f"{spikes / out.spikes.numel():.4f}, dropped "
                f"{int(out.dropped.sum())}, uplink dropped "
                f"{int(out.uplink_dropped.sum())}, launches {counts}")
        if timed:
            stats = stream.stream_latency_stats(out)
            line += (f", delivered {stats['count'] / wall:.4g} events/s, "
                     f"latency median {stats['median_ns']:.0f} ns, p99 "
                     f"{stats['p99_ns']:.0f} ns")
        print(line + f" [{gpu}]", flush=True)
        print(f"phase 3: {name}/{mode}: "
              + device_breakdown(lambda: stream.run_stream(
                  params, state, drives[:PROFILE_STEPS], cfg, fabric=plan,
                  timed=timed, device=DEV)) + f" [{gpu}]", flush=True)


def device_breakdown(fn, per: int = PROFILE_STEPS, unit: str = "step",
                     ours: tuple = ("merge_pack_kernel", "exchange_kernel")
                     ) -> str:
    """Where a short run's time goes, from a torch.profiler trace: the
    card's busy share of the wall time (kernel time summed over the run,
    under the profiler's own overhead) and the share of the busy time in
    the kernels named ``ours``, over ``per`` steps."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Kernel events only: the operators that launched them carry the same
    # time again as their own device time.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    device = {e.key: e.self_device_time_total for e in kernels}
    per_step = sum(e.count for e in kernels) / per
    busy = sum(device.values())
    if not busy:
        return "device time not measured (the profiler saw no kernels)"
    shares = ", ".join(
        f"{name} {sum(t for k, t in device.items() if name in k) / busy:.3f}"
        for name in ours)
    top = ", ".join(f"{k[:40]} {t / busy:.2f}" for k, t in sorted(
        device.items(), key=lambda kv: -kv[1])[:3])
    return (f"{per} profiled {unit}s: {wall_us / per:.0f} us/{unit} wall, "
            f"{per_step:.0f} device operations/{unit}, device busy "
            f"{busy / wall_us:.3f} of it; share of device time: {shares}; "
            f"top: {top}")


# ---------------------------------------------------------------------------
# Phase 4: the card against the CPU
# ---------------------------------------------------------------------------


def phase4() -> None:
    for name, mode, timed in CHECK_PATHS:
        nets = {}
        for side, dev in (("cpu", torch.device("cpu")), ("card", DEV)):
            # The same seed gives the same network on both devices.
            cfg, params, plan = scenarios.engine_network(name, device=dev)
            # Dyadic weights and drives: the synapse product is exact in
            # float32 in any sum order.
            params = params._replace(chips=params.chips._replace(
                w_scale=torch.full_like(params.chips.w_scale, 2.0 ** -8)))
            nets[side] = (params, fablib.with_exchange_mode(plan, mode), dev)
        gen = torch.Generator().manual_seed(4)
        shape = (CHECK_STEPS, cfg.n_chips, BATCH, cfg.chip.n_rows)
        drives = ((torch.rand(shape, generator=gen) < 0.1)
                  * torch.randint(4, 20, shape, generator=gen) / 16)
        state = netlib.init_state(cfg, BATCH, device="cpu")
        runs = {side: stream.run_stream(p, state, drives, cfg, fabric=pl,
                                        timed=timed, device=dev)
                for side, (p, pl, dev) in nets.items()}
        cpu_params, cpu_plan, _ = nets["cpu"]

        def margin_at(t):
            before = (stream.run_stream(cpu_params, state, drives[:t], cfg,
                                        fabric=cpu_plan, device="cpu").state
                      if t else state)
            return parity.spike_margin(cpu_params, before, drives[t], cfg)

        report = parity.compare_streams(runs["cpu"], runs["card"], margin_at)
        # Teacher forcing: both devices route the CPU run's own spikes.
        spikes = runs["cpu"].spikes.transpose(0, 1)
        timing = timed_wire(cfg.latency) if timed else None
        on_cpu = stream.exchange_spikes(cpu_params, spikes, cfg, cpu_plan,
                                        timing)
        on_card = stream.exchange_spikes(nets["card"][0], spikes.to(DEV), cfg,
                                         nets["card"][1], timing)
        for field, a, b in zip(("drives", "dropped", "uplink", "latency_ns",
                                "latency_valid", "unroutable", "rerouted"),
                               on_cpu, on_card):
            parity.assert_equal(f"{name} teacher-forced {field}", a, b)
        spk = int(runs["cpu"].spikes.sum())
        if spk == 0:
            raise AssertionError(f"{name}: no spikes to compare")
        print(f"phase 4: {name}/{mode}/{'timed' if timed else 'untimed'}: "
              f"card == CPU over {CHECK_STEPS} steps ({spk} spikes, "
              f"{len(report['flips'])} near-threshold flips "
              f"{report['flips'][:5]}, final state max err "
              f"{report['state_max_err']}); teacher-forced exchange "
              f"bit-exact", flush=True)


# ---------------------------------------------------------------------------
# Phase 5: the LM main path, zamba2-7b serving at full width and depth
# ---------------------------------------------------------------------------


def lm_counts() -> dict:
    return {"flash_attention": flash_ops.flash_attention.launches,
            "linear_scan": scan_ops.linear_scan.launches}


def phase5(launches: dict, gpu: str) -> None:
    cfg = dataclasses.replace(get_config("zamba2-7b"), attention_impl="pallas")
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device=DEV).manual_seed(0), cfg,
                            DEV)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"phase 5: zamba2-7b, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n_params:.4g} float32 parameters on the card in "
          f"{time.perf_counter() - t0:.1f} s [{gpu}]", flush=True)
    prompts = torch.randint(1, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=torch.Generator(device=DEV)
                            .manual_seed(1), device=DEV)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    flash_ops.flash_attention.launches = 0
    scan_ops.linear_scan.launches = 0
    t0 = time.perf_counter()
    tokens, stats = serve.generate(cfg, params, prompts, LM_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = lm_counts()
    peak = torch.cuda.max_memory_allocated()
    # generate's warm pass runs a second prefill before the timed one.
    groups = cfg.n_layers // cfg.attn_every
    want = {"flash_attention": 2 * groups, "linear_scan": 2 * cfg.n_layers}
    if counts != want:
        raise AssertionError(f"zamba2-7b generate: launches {counts}, "
                             f"expected {want}")
    launches.update(counts)
    if tokens.shape != (LM_BATCH, LM_NEW) or tokens.dtype != torch.int32 \
            or not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"bad tokens {tokens.dtype}{tuple(tokens.shape)}")
    print(f"phase 5: generate batch {LM_BATCH} x prompt {LM_PROMPT} + "
          f"{LM_NEW} new tokens (greedy, warm pass included in the "
          f"{wall:.2f} s wall): prefill {stats.prefill_s * 1e3:.1f} ms "
          f"({LM_BATCH * LM_PROMPT / stats.prefill_s:.0f} prompt tokens/s), "
          f"decode {stats.decode_s * 1e3:.1f} ms = "
          f"{stats.tokens_per_s:.1f} tokens/s "
          f"({stats.decode_s / LM_NEW * 1e3:.1f} ms/step), peak device "
          f"memory {peak / 2**30:.2f} GiB ({resident / 2**30:.2f} GiB "
          f"resident before the call), launches {counts} [{gpu}]",
          flush=True)

    flash_ops.flash_attention.launches = 0
    scan_ops.linear_scan.launches = 0
    out = {}

    def one_prefill():
        out["logits"], out["caches"], _ = lm.prefill(
            params, {"tokens": prompts}, cfg)

    print("phase 5: prefill: " + device_breakdown(
        one_prefill, per=1, unit="prefill",
        ours=("attn_kernel", "scan_kernel")) + f" [{gpu}]",
        flush=True)
    logits = out["logits"]
    dec = serve._splice_prefill(
        cfg, lm.init_cache(cfg, LM_BATCH, LM_PROMPT + 1, DEV),
        out.pop("caches"), LM_PROMPT)
    tok = torch.argmax(logits, -1).to(torch.int32)
    print("phase 5: decode: " + device_breakdown(
        lambda: lm.decode_step(params, tok, dec, LM_PROMPT, cfg), per=1,
        unit="decode step", ours=("attn_kernel", "scan_kernel"))
        + f" [{gpu}]", flush=True)
    if tuple(logits.shape) != (LM_BATCH, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} finite="
                             f"{bool(torch.isfinite(logits).all())}")
    if lm_counts() != {"flash_attention": groups,
                       "linear_scan": cfg.n_layers}:
        raise AssertionError(f"one prefill launched {lm_counts()}")
    del params, logits, out, tokens, dec
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 6: the LM on the card against the CPU
# ---------------------------------------------------------------------------


def phase6() -> None:
    cfg = dataclasses.replace(get_config("zamba2-7b"), n_layers=CHECK_LAYERS,
                              dtype="float32", attention_impl="pallas")
    cpu_params = lm.init_params(torch.Generator().manual_seed(5), cfg, "cpu")
    arrays = {n: p.numpy() for n, p in cpu_params.named_parameters()}
    sides = {"cpu": (convert.lm_params_from_numpy(arrays, cfg, "cpu"), "cpu"),
             "card": (convert.lm_params_from_numpy(arrays, cfg, DEV), DEV)}
    del cpu_params, arrays
    prompts = torch.from_numpy(np.random.default_rng(6).integers(
        1, cfg.vocab_size, (CHECK_BATCH, CHECK_PROMPT)).astype(np.int32))
    res, tok = {}, None
    for side, (params, dev) in sides.items():      # the CPU first
        t0 = time.perf_counter()
        p = prompts.to(dev)
        logits, caches, _ = lm.prefill(params, {"tokens": p}, cfg)
        dec = serve._splice_prefill(
            cfg, lm.init_cache(cfg, CHECK_BATCH, CHECK_PROMPT + 1, dev),
            caches, CHECK_PROMPT)
        if tok is None:
            tok = torch.argmax(logits, -1).to(torch.int32)
        step_logits, _ = lm.decode_step(params, tok.to(dev), dec,
                                        CHECK_PROMPT, cfg)
        tokens, _ = serve.generate(cfg, params, p, CHECK_NEW, warm=False)
        res[side] = [t.cpu() for t in (logits, step_logits, tokens)]
        print(f"phase 6: {side} side in {time.perf_counter() - t0:.1f} s",
              flush=True)
    errs = []
    for name, a, b in zip(("prefill logits", "decode-step logits"),
                          res["cpu"][:2], res["card"][:2]):
        err = float((a - b).abs().max())
        errs.append(err)
        if not bool(torch.isfinite(b).all()) or err > CHECK_LOGIT_TOL:
            raise AssertionError(f"{name}: card vs CPU max abs err {err} > "
                                 f"{CHECK_LOGIT_TOL}")
    if not torch.equal(res["cpu"][2], res["card"][2]):
        raise AssertionError(f"greedy tokens differ: {res['cpu'][2]} vs "
                             f"{res['card'][2]}")
    print(f"phase 6: zamba2-7b full width, {CHECK_LAYERS} layers, float32, "
          f"batch {CHECK_BATCH} x prompt {CHECK_PROMPT}: card == CPU; "
          f"prefill logits max abs err {errs[0]:.3g}, decode-step logits "
          f"{errs[1]:.3g} (tolerance {CHECK_LOGIT_TOL}, logits up to "
          f"{float(res['cpu'][0].abs().max()):.3g}); {CHECK_NEW} greedy "
          f"tokens equal {res['cpu'][2].tolist()}", flush=True)
    del sides
    gc.collect()
    torch.cuda.empty_cache()



def main() -> None:
    gpu = card()
    print(f"phase 1: card {gpu}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"phase 1: built {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for stem, path in sorted(libs.items()):
        log = pathlib.Path(f"{path}.log")
        usage = [ln.strip() for ln in (log.read_text().splitlines()
                                       if log.exists() else [])
                 if "registers" in ln or "spill" in ln]
        print(f"phase 1: {stem}: {' | '.join(usage) or 'cached build'}",
              flush=True)

    results: dict = {}
    phase2(results)
    phase2_lm(results)
    launches = {k: 0 for k in KERNEL_SOURCES}
    phase3(launches, gpu)
    phase4()
    phase5(launches, gpu)
    phase6()

    kernels = []
    for k, (source, replaces) in KERNEL_SOURCES.items():
        r = results[k]
        kernels.append(dict(
            name=k, route="cuda", source=source, replaces=replaces,
            launches=launches[k], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r.get("library_ms")))
        if not launches[k]:
            raise AssertionError(f"{k} never launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
