"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. Environment: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the build of the CUDA kernels from
   ``src/repro_torch/kernels/**/csrc`` into ``build/repro_torch/`` (one
   ``nvcc`` per source, all at once).
2. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and in every variant: the exchange, egress-router and
   streaming-exchange kernels bit-exact (disabled LUT entries and capacity
   overflow included), the LIF step within 1e-6, the LM kernels within a
   stated tolerance, each through its bodies (flash attention's wgmma
   body against its blocked twin and the plain version at d = 112, 128,
   192 and 256, gemma-7b's shape at batch 1 among them; its decode body
   against its split twin on whisper's q1 cross-attention, a GQA q16
   call and a causal s16 call, each timed beside SDPA and its bound;
   its f32 body; the scan's scalar-decay body against its twin and the chunked
   form, its per-channel body); device time per launch (CUDA-graph
   replay), the plain version's time, a library call's time where one
   computes the same function, and the bound.  The streaming exchange is
   also timed, in turns, against the exchange kernel run with batch = T
   on the same frames.  The per-slot STDP kernel, which replaces no TPU
   kernel, at the engine's [96, 64, 256, 512], unmasked and masked: traces
   and weights bit for bit except at float32 rounding midpoints of the
   plain version's float64 sums, its inputs unchanged, time as called.  Every SNN kernel case names the body it ran and
   prints its launch floor: the graph-replay time of an empty kernel with
   the same grid, block and shared memory (``*_floor_launch`` in the
   kernels' sources); cases reach every body of the exchange, merge_pack,
   egress-router and streaming kernels.  One merge_pack case takes the
   inputs of a masked step of phase 9 (EXT_4CASE_96CHIP, whole segments
   invalid).
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
   (13 flash-attention launches through the wgmma body and 81 linear-scan
   launches through the scalar-decay body per prefill, two prefills with
   the warm pass), and a profiler pass over one prefill and one decode
   step.
6. The LM on the card against the CPU: the same converted weights at full
   width, 7 layers, float32 (the kernels' f32 and per-channel bodies),
   batch 2 x prompt 64; prefill and decode-step logits within a stated
   tolerance, and the 4 greedy tokens equal.
7. The interconnect path on FULL_BACKPLANE at the catalogue's 5%
   occupancy: 64 steps of 12 x 64 egress frames through one
   ``fused_exchange_stream`` launch, equal bit for bit to 64 ``route_step``
   calls (µs/step of each); then the Node-FPGA egress stage
   (``route_and_pack``, identity fwd LUT, cap_in 32) on the spike rasters
   of a phase-3-sized PROJECTED_120CHIP run (batch 8, 120 chips x 512
   neurons, 64 steps), bit for bit against its plain version, with the
   label grid and rasters read in place (µs/step as called, beside the
   same loop on the caller's contiguous copies).  The stream's launch
   and all 64 egress launches must take the row body.
8. The LIF path: 64 steps of ``lif_step`` at the chips' full width
   (8 x 120 chips, 512 neurons), teacher-forced: at each step the kernel
   and ``lif_step_ref`` start from the plain trajectory's state and agree
   within 1e-6, spikes equal except where the plain membrane is within
   1e-6 of the threshold.
9. The degraded-mode stream at phase 3's width and drives: ``run_stream``
   with fault schedules in mask and reroute modes on EXT_4CASE_96CHIP
   (timed; gather in both modes, routed in mask mode) and FULL_BACKPLANE
   (untimed gather), each run's launch counts checked (an overlay step
   never takes the exchange fast path, a healthy reroute segment does);
   events lost exactly in the steps where a dead edge without a route
   carries traffic in phase 3's healthy run, rerouted exactly where a
   live detour does, and spikes equal to the healthy run's through the
   first losing step; steps/s beside phase 3's, a profiler pass over 8
   faulted steps; then phase 4's card-against-CPU check on
   EXT_4CASE_96CHIP in each fault mode, the exchange teacher-forced with
   each step's overlay or degraded plan.
10. The rest of ``run_stream``'s event path at phase 3's width and drives:
   PROJECTED_120CHIP (timed) through ``topology="hierarchical"``, equal bit
   for bit to the ``fabric=`` run of the catalogue plan and to phase 3's
   spikes; ``overlap=True`` against ``overlap=False`` (0.25 µs steps, a
   4-deep delay line) on FULL_BACKPLANE untimed (the exchange kernel) and
   EXT_4CASE_96CHIP timed (merge_pack), in turns; 64 teacher-forced
   FULL_BACKPLANE rounds with ``engine="merge"`` (merge_pack's ``block``
   body) against ``"auto"`` (the exchange kernel); ``use_fused=False``
   (no kernel) against the fused run on EXT_4CASE_96CHIP timed, in turns;
   ``pick_exchange_mode`` over 64 EXT_4CASE_96CHIP rounds; the per-step
   ``run_event_steps`` against ``run_event``; each run's launches by body
   checked, and phase 4's card-against-CPU check on a 16-step overlap +
   hierarchical-flag run.
11. The Fig 5 latency model: ``simulate_fan_in`` at the paper's 2^15
   spikes, fan-in 3, over ``benchmarks/fig5_latency.py``'s 8 rates at both
   levels, the card against the CPU on the same draws bit for bit, the
   reference battery's Fig 5 properties (chip medians inside the paper's
   band and monotone, 8 ns ticks, the worst-regime jitter), and
   ``hop_delays(...).total_ns`` against ``queue_wait_i32``; ms a call on
   the card and on the host.
12. Online plasticity at phase 3's width and drives: shared plasticity on
   EXT_4CASE_96CHIP (timed) and FULL_BACKPLANE (untimed), per-slot
   plasticity on EXT_4CASE_96CHIP with slots 4-7 idle over steps 16-47,
   each in turns with the plain run (6 turns each) and launching what
   phase 3's run does, by body; bit for bit: chained windows against one
   run, the idle slots' silence and frozen traces and weights, overlap
   against the plain loop (FULL_BACKPLANE, 0.25 us steps), each per-slot
   row against a batch-1 run; peak device memory, a profiler pass over 8
   plastic steps, and phase 4's card-against-CPU check on 16 plastic
   steps with the flips judged on the evolving weights.  Each per-slot
   step launches the STDP kernel once; phases 12-13's launches of it are
   its count in the kernels line.
13. The durable runtime and the multi-tenant engine at full chip width:
   the supervised shared-plastic stream against one long run, a kill and
   resume, a watchdog recovery onto a degraded plan, the engine's sessions
   against batch-1 runs, an evicted session, ``serve_emulation`` and the
   engine on the card against the CPU.
14. The sharded fabric executor on ``torch.distributed``: gloo ranks that
   all use the one card (NCCL takes one card per rank), so the merge_pack
   kernel runs on the card and the wire goes through host memory.  (a)
   FULL_BACKPLANE at full width on 12 ranks (cap_in 64, capacity 256) at
   the catalogue's 5% and at 50% occupancy, 64 rounds through
   ``FabricInterconnect.stream_fn`` and through 64 ``exchange_fn`` calls,
   gather and routed, untimed and timed; (b) EXT_4CASE_96CHIP's three
   levels at fan-in 2 on 8 ranks (cap_in 24, capacity 96, the twin's
   ``level_caps``), healthy, one dead uplink, exhausted and a health
   overlay, in the same four ways, 64 rounds through ``stream_fn`` and
   the first 16 through ``exchange_fn``; (c) ``StarInterconnect``: the
   star on 12 ranks and the 3 x 4 hierarchy, with and without the uplink
   caps, likewise, and ``barrier`` all ready and one rank not ready.  The
   meshes are the card's (``fabric_mesh(plan)`` at its default).  Every
   rank equals the stacked executor on the card and on the CPU bit for
   bit (labels, valid, times, the four drop fields), the stream equals
   the loop, merge_pack launches are checked per rank by body over every
   call, routed rounds make no all-gather, and the wire bytes a rank
   receives match the plan; µs a round a rank for both entry points.

15. The dense surrogate and surrogate-gradient training at full chip
   width: (a) for A, ``examples/multichip_snn.py``'s network (3 chips,
   capacity 600, T = 32, batch 16), and B, one backplane (12 chips, T =
   64), the dense run (``routing_matrices``, ``run_stream(mode="dense")``:
   a cuBLAS product a step, no spike-router kernel) equals the event run
   (the exchange kernel once a step, nothing dropped) bit for bit, and the
   dense run on the card equals the CPU's (``repro_torch.parity``,
   near-threshold flips reported with their margins); steps/s of both in
   6 turns, device operations a step and the busy share; (b) 60
   ``train_step``s of A on card batches from ``make_batch``: the first
   step's loss, gradient and new weights equal the CPU's on the same
   batch, ms a train step, peak device memory, the busy share and the
   losses (the mean of the first and the last 5); (c) 10 train steps of
   B: ms a step and peak device memory; then 30 steps of R, the
   reference's training test's network (2 chips, T = 24): the mean loss
   of the last 5 steps must lie below that of the first 5.
16. The fabric verifier on the card (``repro_torch.analysis.lint.run_lint(
   device="cuda")``) over the whole catalogue at its real sizes
   (FULL_BACKPLANE, PROJECTED_120CHIP, EXT_4CASE_96CHIP and its degraded
   variants): the plan verifier, the program lint (``fabric_route_step``
   gather and routed on the card, each plan's shrunk twin on gloo ranks
   sharing the card, ``run_stream``), the pack units' write-set model
   check, and the card check, which launches every body of the four
   router kernels on the mask battery and reads each kernel's scatter
   map off its output; zero errors, the findings per check, the launches
   by body and the wall time.  Then the card check again under
   ``compute-sanitizer`` memcheck and racecheck where the sanitizer
   supports the card (the line says when it does not).

17. The RWKV6, dense and MoE families: the linear scan's ``bonus`` mode at
   rwkv6-7b's shape (b4 h64 t2048, the per-channel body) and flash
   attention at the prefill shape of each attention config (gemma-7b's
   d = 256, smollm-135m's d = 64 with GQA group 3, d = 128 with groups 4
   and 6) against their plain versions, with the body, its KV tile, time
   per launch, bound and SDPA's time; ``serve.generate`` at phase 5's batch, prompt and new tokens for
   rwkv6-7b, smollm-135m, gemma-7b, qwen3-8b and phi3-medium-14b at full
   width and depth and grok-1-314b at full width and 2 of its 64 layers
   (random float32 weights, bf16 activations), each with its launches by
   body checked (two prefills: the scan's per-channel body per RWKV6
   layer, wgmma per attention layer), prefill and decode times, peak
   device memory (phi3 under 70 GiB), a profiler pass over one prefill
   and grok-1's dropped share per layer; then rwkv6-7b and gemma-7b at 2
   full-width float32 layers on the card against the CPU (prefill logits
   and every cache leaf).
18. The last three LM families: flash attention at the shapes their
   serving gives it for the first time, against its plain versions, with
   time per launch, bound and SDPA's time (MLA's d = 192 with V
   zero-padded from 128, b4 h128 s2048 causal; whisper's encoder, s1500
   not causal; its cross-attention, q256 and q1 against 1500 frames, q1
   on the decode body);
   serving at batch 4 and 32 greedy new tokens, bf16 activations:
   deepseek-v2-236b at full width and 2 of 60 layers (the dense first
   layer and a MoE layer of 160 experts) through ``serve.generate``,
   whisper-medium at full depth (1500 frames, a decoder prompt of 256)
   and llava-next-mistral-7b at full depth (2048 prompt embeddings)
   through ``prefill``, ``_splice_prefill`` and ``decode_step``; each
   with prefill and decode times, peak device memory, launches by body
   checked a prefill and a decode step (whisper's decode step: 24 decode
   launches, no wgmma), a profiler pass over one prefill;
   then each at 2 full-width float32 layers on the card against the CPU
   (logits, every cache leaf, whisper's encoder output, 4 greedy tokens,
   deepseek's dropped events).
19. LM training (no kernel on its path: the JAX package trains under
   ``attention_impl="xla"``, and the LM kernels refuse a gradient): (a)
   one train step (loss, MoE aux loss and every gradient leaf, float32)
   of the ten smoke archs and of smollm-135m at full width and 2 of 30
   layers on the card against the CPU; (b) smollm-135m at full width and
   depth, bf16 compute, remat, batch 8 x 2048, 100 AdamW steps through
   ``runtime.trainer.Trainer`` with checkpoints at 50 and 100: the loss
   must fall; ms a step, tokens/s, peak device memory, no LM kernel
   launched; a fresh Trainer resumed at step 50 replays steps 50-54
   (max |dloss|), and a profiler pass over one step; (c) under
   ``"pallas"`` a train step raises before any launch, and the same call
   under ``no_grad`` launches.
20. The LM shardings (no kernel on their path): (a) gradient compression
   at full width, smollm-135m's gradient leaves from a seed:
   ``compress_with_feedback`` for 4 rounds at frac 0.01 and
   ``quantize_int8``, the card against the CPU bit for bit (indices,
   values, residuals, int8 codes), ms a round; (b) the sharded train step
   (``make_train_step(mesh=)``, DTensor) on one rank and a 1 x 1 mesh,
   smollm-135m at full width and depth, bf16, remat, batch 8 x 2048, 10
   steps in turns with 10 of phase 19's plain step from the same state:
   ms a step and tokens/s of both, the losses equal within 1e-6 relative
   (else the first op that differs is named), and a ``FlopCounterMode``
   count of the plain step; then 4 gloo ranks on a 2 x 2 mesh, smollm-135m
   at full width and 2 layers, float32: the loss within 1e-4 relative and
   every parameter after one step within 1e-5 x max|p| of the one-rank
   step (``SHARD_GROUP_DEVICE`` says where those ranks run); (c) the dry
   run (``python -m repro_torch.launch.dryrun``, a fake group of 256 ranks
   in a subprocess) of smollm-135m and qwen3-8b at train_4k on 16 x 16:
   each roofline row and its wall time; then the roofline of (b)'s shape
   on a 1 x 1 mesh, its flops equal to (b)'s count, its ``bound_s``
   beside the measured ms a step.
21. The four example scripts (``examples/*_torch.py``), each through its
   ``main`` in this process on the card: quickstart and multichip_snn at
   their defaults, serve_lm with ``--arch qwen3-8b`` and ``--arch
   rwkv6-7b`` (smoke configs, bf16, ``"pallas"``), train_lm at its
   defaults (smollm-135m at full width and depth, 200 steps of batch 4 x
   64) with ``--simulate-failure``, its checkpoints in a temporary
   directory under ``build/``.  The scripts' own checks hold (event ==
   dense and stream == loop, no drops, the latency budget's line, the
   loss falls after the resume at step 100), each script's launches by
   kernel body are checked and added to the kernels line, and one line a
   script gives its wall time, its launches and its numbers.  What the
   scripts launched is held against the plain versions: quickstart's chip
   run again, its spikes routed through the exchange kernel and through
   ``use_fused=False`` (bit for bit); serve_lm's prefill logits on the
   same parameters and prompts through the kernels and through the plain
   path (``attention_impl="xla"``), and the kernel alone at the smoke
   prefill's shape against its plain version.

Each phase prints its wall time.  Any failure exits non-zero.  The line
before the card's name lists each kernel's launches on the main paths,
time, plain time, library time and bound (``replaces`` is null for the
STDP kernel, which no TPU kernel precedes); the LM kernels' entries add
their launches by body (flash attention's decode body must have served
whisper's decode steps, its wgmma body the prefills).  The last line is
the result for the harness.
It needs the repository's ``src/`` beside it and a CUDA device; without
either it fails before printing a result.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import gc
import itertools
import json
import math
import pathlib
import re
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
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import aggregator as agg  # noqa: E402
from repro_torch.core import fabric as fablib  # noqa: E402
from repro_torch.core import routing  # noqa: E402
from repro_torch.core import sync  # noqa: E402
from repro_torch.core.events import EventFrame, make_frame  # noqa: E402
from repro_torch.kernels import INT, PTR, _build, check  # noqa: E402
from repro_torch.kernels import launcher  # noqa: E402
from repro_torch.kernels import stream as cuda_stream  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref)
from repro_torch.kernels.lif_step import ops as lif_ops  # noqa: E402
from repro_torch.kernels.lif_step.ref import lif_step_ref  # noqa: E402
from repro_torch.kernels.linear_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.linear_scan.ref import (  # noqa: E402
    linear_scan_channel_decay_ref, linear_scan_chunked,
    linear_scan_scalar_decay_ref)
from repro_torch.kernels.spike_router import ops, ref  # noqa: E402
from repro_torch.kernels.stdp_slot import ops as stdp_ops  # noqa: E402
from repro_torch.kernels.stdp_slot import ref as stdp_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.models import moe as moelib  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.snn import network as netlib  # noqa: E402
from repro_torch.snn import neuron as nrn  # noqa: E402
from repro_torch.snn import stream  # noqa: E402
from repro_torch.core import latency  # noqa: E402
from repro_torch.core.latency import timed_wire  # noqa: E402
from repro_torch.snn import plasticity as plas  # noqa: E402
from repro_torch.snn import training  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.launch import serve_emulation  # noqa: E402
from repro_torch.runtime import elastic, engine, watchdog  # noqa: E402
from repro_torch.data import pipeline as lmdata  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import trainer as lmtrainer  # noqa: E402
from repro_torch.parallel import compression  # noqa: E402

DEV = torch.device("cuda")
SMS = torch.cuda.get_device_properties(DEV).multi_processor_count
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
    "exchange_stream": (
        "src/repro_torch/kernels/spike_router/csrc/exchange_stream.cu",
        "src/repro/kernels/spike_router/spike_router.py:419"),
    "spike_router": (
        "src/repro_torch/kernels/spike_router/csrc/spike_router.cu",
        "src/repro/kernels/spike_router/spike_router.py:343"),
    "lif_step": ("src/repro_torch/kernels/lif_step/csrc/lif_step.cu",
                 "src/repro/kernels/lif_step/lif_step.py:50"),
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:129"),
    "linear_scan": ("src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu",
                    "src/repro/kernels/linear_scan/linear_scan.py:106"),
    # Replaces no TPU kernel: the JAX package's per-slot STDP step is plain
    # jnp, which XLA fuses.
    "stdp_slot": ("src/repro_torch/kernels/stdp_slot/csrc/stdp_slot.cu",
                  None),
}
# linear_scan's bodies and their sources (the kernels line notes both).
SCAN_SOURCES = {
    "scalar_decay": "src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu",
    "channel_decay":
        "src/repro_torch/kernels/linear_scan/csrc/channel_decay.cu",
    "per_channel": "src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu"}
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
# Phase 9's fault schedules over STEPS = 64: backplane 0's uplink dead for
# steps 16-47 and leaf 3's downlink from step 32 on (EXT_4CASE_96CHIP), leaf
# 0's uplink dead for steps 16-47 (FULL_BACKPLANE); the first scaled to
# steps 4-12 of CHECK_STEPS = 16 for the card-against-CPU check.
EXT_FAULTS = (fablib.FaultEvent(1, 0, kill_step=16, restore_step=48),
              fablib.FaultEvent(0, 3, kill_step=32, kind="downlink"))
FULL_FAULTS = (fablib.FaultEvent(0, 0, kill_step=16, restore_step=48),)
CHECK_FAULTS = (fablib.FaultEvent(1, 0, kill_step=4, restore_step=12),
                fablib.FaultEvent(0, 3, kill_step=8, kind="downlink"))
# Phase 9's runs: (scenario, exchange mode, timed, fault mode, schedule,
# launches by body expected over STEPS steps).  A step with an overlay never takes
# the exchange fast path; a reroute segment with no dead edge does.
FAULT_PATHS = (
    ("EXT_4CASE_96CHIP", "gather", True, "mask", EXT_FAULTS,
     {"merge_pack warp": STEPS}),
    ("EXT_4CASE_96CHIP", "gather", True, "reroute", EXT_FAULTS,
     {"merge_pack warp": STEPS}),
    ("EXT_4CASE_96CHIP", "routed", True, "mask", EXT_FAULTS,
     {"merge_pack warp": STEPS}),
    ("FULL_BACKPLANE", "gather", False, "mask", FULL_FAULTS,
     {"merge_pack block": STEPS}),
    ("FULL_BACKPLANE", "gather", False, "reroute", FULL_FAULTS,
     {"merge_pack block": STEPS // 2, "exchange row": STEPS // 2}),
)
# Phase 7 and the streaming/egress cases of phase 2: the egress frame width
# of each scenario (analysis.scenarios.CASES' cap_in), the catalogue's
# occupancy, and the Node-FPGA egress pack of the PROJECTED_120CHIP rasters.
OCC = scenarios.OCC_HEADLINE
EGRESS_CAP = 32
# Phases 2 and 8: the LIF step within 1e-6 (both sides round in float32; the
# kernel keeps the TPU kernel's operation order without FMA, the plain
# version neuron_step's association of the membrane sum); a spike may flip
# only where the plain membrane lies within that of the threshold.
LIF_TOL = 1e-6
LIF_BATCH, LIF_CHIPS = BATCH, 120
LIF_SETS = 16                    # 16 x 5.9 MB of inputs: past the 50 MB L2


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def ptxas_usage(log: str) -> list[str]:
    """Per kernel function of an ``nvcc -Xptxas -v`` log: its name with
    template arguments, registers, spilled bytes, static shared memory and
    any performance warning (``scan_scalar_decay_kernel<4,64>: 167 regs,
    0 B spilled, 0 B smem``; dynamic shared memory is the launch's)."""
    usage, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?([A-Za-z_]+kernel)"
                      r"(I(?:L[ib]\d+E)+E)?", ln)
        if m:
            args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
            name = m.group(1) + (f"<{','.join(args)}>" if args else "")
        elif name and "spill stores" in ln:
            spill = re.search(r"(\d+) bytes spill stores", ln).group(1)
        elif name and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            smem = re.search(r"(\d+) bytes smem", ln)
            usage.append(f"{name}: {regs} regs, {spill} B spilled, "
                         f"{smem.group(1) if smem else 0} B smem")
            name = None
        elif "Performance" in ln:
            usage.append(ln.split(":", 1)[-1].strip()[:90])
    return usage


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


def exchange_cost(labels, valid, enables, outs) -> tuple[int, int]:
    """Bytes an exchange round must move (frames read once, the fwd entries
    of the valid events, the enables, the rev entries of the kept events,
    outputs written once) and its integer operations (about ten per input
    slot and destination, and per output slot)."""
    n_dst = enables.shape[1]
    nbytes = (labels.numel() * 5 + 4 * int(valid.sum()) + enables.numel()
              + 4 * int(outs[1].sum())
              + sum(o.numel() * o.element_size() for o in outs))
    return nbytes, 10 * (labels.numel() * n_dst + outs[0].numel())


def run_counted(fn, counts: dict):
    """Runs ``fn`` (one wrapper call) and returns (its result, the body its
    launch went through, from the wrapper's ``launches_by_path``)."""
    before = dict(counts)
    out = fn()
    bodies = [k for k in counts if counts[k] != before[k]]
    if len(bodies) != 1 or counts[bodies[0]] != before[bodies[0]] + 1:
        raise AssertionError(f"expected one launch, bodies went {before} -> "
                             f"{counts}")
    return out, bodies[0]


def merge_pack_floor_ms(rows: int, n: int, cap: int, timed: bool,
                        body: str) -> float:
    """The launch floor of a merge_pack call: graph replay of an empty
    kernel with the grid, block and shared memory of ``body`` at
    rows x n -> cap."""
    launch = launcher("merge_pack", "merge_pack_floor_launch",
                      (INT,) * 5 + (PTR,))
    code = ops.MERGE_PACK_BODIES[body]
    return graph_ms(lambda: check(launch(rows, n, cap, int(timed), code,
                                         cuda_stream()),
                                  "merge_pack floor"))


def exchange_floor_ms(labels, n_dst: int, cap: int, body: str) -> float:
    """The launch floor of an exchange call: graph replay of an empty
    kernel with the grid, block and shared memory of ``body``."""
    launch = launcher("exchange", "exchange_floor_launch",
                      (INT,) * 6 + (PTR,))
    batch, n_src, cap_in = labels.shape
    code = ops.EXCHANGE_BODIES[body]
    return graph_ms(lambda: check(launch(batch, n_src, cap_in, n_dst, cap,
                                         code, cuda_stream()),
                                  "exchange floor"))


def spike_router_floor_ms(rows: int, n: int, cap: int, body: str) -> float:
    """The launch floor of a spike_router call: graph replay of an empty
    kernel with the grid, block and shared memory of ``body``."""
    launch = launcher("spike_router", "spike_router_floor_launch",
                      (INT,) * 4 + (PTR,))
    code = ops.ROUTE_AND_PACK_BODIES[body]
    return graph_ms(lambda: check(launch(rows, n, cap, code, cuda_stream()),
                                  "spike_router floor"))


def stream_floor_ms(labels, n_dst: int, cap: int, body: str) -> float:
    """The launch floor of an exchange_stream call: graph replay of an
    empty kernel with the grid, block and shared memory of ``body``."""
    launch = launcher("exchange_stream", "exchange_stream_floor_launch",
                      (INT,) * 7 + (PTR,))
    steps, n_src, cap_in = labels.shape
    groups = ops.row_groups(steps, n_dst, SMS) if body == "row" else 1
    return graph_ms(lambda: check(launch(steps, n_src, cap_in, n_dst, cap,
                                         ops.EXCHANGE_BODIES[body], groups,
                                         cuda_stream()),
                                  "exchange_stream floor"))


def recorded_merge(fn):
    """Runs ``fn`` and returns the (args, kwargs) of the one
    ``fused_merge_pack`` call that ``fabric_route_step`` made in it."""
    real, seen = fablib.fused_merge_pack, []

    def record(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    fablib.fused_merge_pack = record
    try:
        fn()
    finally:
        fablib.fused_merge_pack = real
    if len(seen) != 1:
        raise AssertionError(f"{len(seen)} merge_pack calls, expected 1")
    return seen[0]


def dead_segments(valid, seg_lens) -> int:
    """Merge segments with no valid slot, over all rows."""
    parts = torch.split(valid.reshape(-1, valid.shape[-1]), list(seg_lens),
                        dim=-1)
    return sum(int((~p.any(dim=-1)).sum()) for p in parts)


def masked_merge_inputs(gen):
    """The merge_pack inputs of a masked mask-mode step of EXT_4CASE_96CHIP
    (step 40 of phase 9's schedule: backplane 0's uplink and leaf 3's
    downlink masked), timed, on random rasters at the catalogue occupancy;
    with the count of wholly invalid segments, masked and healthy."""
    cfg, params, plan = scenarios.engine_network("EXT_4CASE_96CHIP",
                                                 device=DEV)
    spikes = (torch.rand((cfg.n_chips, BATCH, cfg.chip.n_neurons),
                         generator=gen, device=DEV) < OCC).to(torch.float32)
    health = stream.health_at(
        fablib.health_schedule(plan, EXT_FAULTS, STEPS, device=DEV), 40)
    timing = timed_wire(cfg.latency)
    args, kw = recorded_merge(lambda: stream.exchange_spikes(
        params, spikes, cfg, plan, timing, health))
    h_args, h_kw = recorded_merge(lambda: stream.exchange_spikes(
        params, spikes, cfg, plan, timing))
    dead = (dead_segments(args[1], kw["seg_lens"]),
            dead_segments(h_args[1], h_kw["seg_lens"]))
    return (args, dict(kw)), (h_args, dict(h_kw)), dead


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
        got, body = run_counted(lambda: ops.fused_merge_pack(*args, **kw),
                                ops.fused_merge_pack.launches_by_path)
        want = ref.merge_pack_ref(*args, **kw)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        if e:
            raise AssertionError(f"merge_pack {name}: kernel != plain "
                                 f"(max abs err {e})")
        err = max(err, e)
        ms = graph_ms(lambda: ops.fused_merge_pack(*args, **kw))
        floor = merge_pack_floor_ms(rows, sum(segs), cap, timed, body)
        nbytes, nops = merge_cost(args, kw, got)
        b_ms, b_by = bound(nbytes, nops)
        print(f"phase 2: merge_pack {name}: rows {rows} x {sum(segs)} "
              f"events -> cap {cap}, dropped {int(got[-1].sum())}, exact; "
              f"{body} body: kernel {ms * 1e3:.2f} us, launch floor "
              f"{floor * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by})",
              flush=True)
        if name == "ext_gather_timed":
            main_case = (args, kw, ms, floor, b_ms, b_by)
    # Phase 9's traffic: a masked mask-mode step, whole segments invalid.
    (args, kw), (h_args, h_kw), (dead, healthy_dead) = masked_merge_inputs(
        gen)
    if dead <= healthy_dead:
        raise AssertionError(f"merge_pack masked step: {dead} wholly invalid "
                             f"segments, healthy {healthy_dead}")
    got, body = run_counted(lambda: ops.fused_merge_pack(*args, **kw),
                            ops.fused_merge_pack.launches_by_path)
    want = ref.merge_pack_ref(*args, **kw)
    torch.cuda.synchronize()
    e = max_abs_err(got, want)
    if e:
        raise AssertionError(f"merge_pack masked mask-mode step: kernel != "
                             f"plain (max abs err {e})")
    err = max(err, e)
    rows, n = args[0].shape[0] * args[0].shape[1], args[0].shape[-1]
    # In turns with the healthy step of the same rasters.
    times = [graph_ms(lambda: ops.fused_merge_pack(*a, **k))
             for a, k in ((args, kw), (h_args, h_kw), (h_args, h_kw),
                          (args, kw))]
    floor = merge_pack_floor_ms(rows, n, kw["capacity"], True, body)
    b_ms, b_by = bound(*merge_cost(args, kw, got))
    print(f"phase 2: merge_pack ext_masked_mask_mode_step: rows {rows} x {n} "
          f"events -> cap {kw['capacity']}, {dead} of "
          f"{rows * len(kw['seg_lens'])} segments wholly invalid (healthy "
          f"step {healthy_dead}), dropped {int(got[-1].sum())}, exact; "
          f"{body} body: kernel {times[0] * 1e3:.2f} / "
          f"{times[3] * 1e3:.2f} us (the healthy step of the same rasters, "
          f"in turns: {times[1] * 1e3:.2f} / {times[2] * 1e3:.2f} us), "
          f"launch floor {floor * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us "
          f"({b_by})", flush=True)
    args, kw, ms, floor, b_ms, b_by = main_case
    results["merge_pack"] = dict(
        max_abs_err=err, ms=ms, floor_ms=floor,
        plain_ms=eager_ms(lambda: ref.merge_pack_ref(*args, **kw)),
        eager_ms=eager_ms(lambda: ops.fused_merge_pack(*args, **kw)),
        bound_ms=b_ms, bound_by=b_by)

    # The exchange kernel: FULL_BACKPLANE's shape (batch x 12 sources x 256
    # egress slots, capacity 256), identity-like tables and all-to-all
    # enables as on the main path, then random tables, random enables and
    # dense traffic so destinations overflow; 12 sources into 7
    # destinations; and two frames for the tiled body: 24 sources (past
    # one CTA's 4,096 items) and PROJECTED_120CHIP's 120 chips as one star
    # (more sources than a warp has lanes).
    cfg, plan = plans["FULL_BACKPLANE"]
    n, cap = cfg.n_chips, cfg.capacity
    params = netlib.to_device(
        scenarios.engine_network("FULL_BACKPLANE", device="cpu")[1], DEV)
    err = 0.0
    main_case = None
    # (case, n_src, n_dst, cap_in, capacity, occupancy, random tables)
    for name, n_src, n_dst, cap_in, cap, occ, random_luts in (
            ("main_path_tables", n, n, 256, cap, 0.05, False),
            ("random_tables_overflow", n, n, 256, cap, 0.6, True),
            ("random_tables_12_to_7", n, 7, 256, cap, 0.3, True),
            ("random_tables_24_sources", 24, n, 256, cap, 0.3, True),
            ("random_tables_120_chip_star", 120, 120, 64, 128, 0.05, True)):
        labels = ((torch.arange(n_src, device=DEV, dtype=torch.int32)[:, None]
                   << 9) + torch.randint(0, 512, (BATCH, n_src, cap_in),
                                         generator=gen, device=DEV,
                                         dtype=torch.int32))
        valid = torch.rand((BATCH, n_src, cap_in), generator=gen,
                           device=DEV) < occ
        if random_luts:
            fwd = lut(gen, n_src, 1 << 16, 15, 15)
            rev = lut(gen, n_dst, 1 << 15, 16, 16)
            enables = torch.rand((n_src, n_dst), generator=gen,
                                 device=DEV) < 0.7
        else:
            fwd, rev = params.router.fwd_tables, params.router.rev_tables
            enables = torch.from_numpy(plan.levels[0].enables).to(DEV)
        args = (labels, valid, fwd, rev, enables)
        want = ref.exchange_ref(*args, capacity=cap)
        got, body = run_counted(lambda: ops.fused_exchange(*args,
                                                           capacity=cap),
                                ops.fused_exchange.launches_by_path)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        if e:
            raise AssertionError(f"exchange {name} ({body}): kernel != "
                                 f"plain (max abs err {e})")
        err = max(err, e)
        ms = graph_ms(lambda: ops.fused_exchange(*args, capacity=cap))
        floor = exchange_floor_ms(labels, n_dst, cap, body)
        b_ms, b_by = bound(*exchange_cost(labels, valid, enables, got))
        print(f"phase 2: exchange {name}: {BATCH} x {n_src} x {cap_in} "
              f"-> {n_dst} x cap {cap}, dropped {int(got[2].sum())}, "
              f"exact; {body} body: kernel {ms * 1e3:.2f} us, launch floor "
              f"{floor * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by})",
              flush=True)
        if main_case is None:
            main_case = (args, ms, floor, b_ms, b_by)
    args, ms, floor, b_ms, b_by = main_case
    results["exchange"] = dict(
        max_abs_err=err, ms=ms, floor_ms=floor,
        plain_ms=eager_ms(lambda: ref.exchange_ref(*args, capacity=cap)),
        eager_ms=eager_ms(lambda: ops.fused_exchange(*args, capacity=cap)),
        bound_ms=b_ms, bound_by=b_by)
    for k, r in results.items():
        print(f"phase 2: {k}: kernel {r['ms'] * 1e3:.2f} us (graph replay), "
              f"launch floor {r['floor_ms'] * 1e3:.2f} us, "
              f"{r['eager_ms'] * 1e3:.2f} us as called, plain "
              f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.3f}"
              f" us ({r['bound_by']})", flush=True)


# ---------------------------------------------------------------------------
# Phase 2, the egress router, the streaming exchange and the LIF step
# ---------------------------------------------------------------------------


def egress_case(gen, lead, occ, random_lut):
    """Egress frames at the PROJECTED_120CHIP shape: labels chip << 9 |
    neuron and the identity fwd LUT (chips 64 and up hit disabled entries),
    or labels anywhere in int32 and a random LUT, ~15% disabled."""
    cfg = netlib.NetworkConfig(n_chips=lead[-1])
    grid = stream.egress_label_grid(cfg, DEV)
    valid = torch.rand((*lead, grid.shape[-1]), generator=gen,
                       device=DEV) < occ
    if random_lut:
        labels = torch.randint(-(1 << 31), (1 << 31) - 1, valid.shape,
                               generator=gen, device=DEV, dtype=torch.int32)
        table = lut(gen, 1, 1 << 16, 15, 15)[0]
    else:
        labels = grid.expand(valid.shape).contiguous()
        table = agg.identity_router(1, device=DEV).fwd_tables[0]
    return labels, valid, table


def router_cost(labels, valid, outs) -> tuple[int, int]:
    """Bytes the egress stage must move (labels and flags read once, the
    LUT entries of the valid events, outputs written once) and its integer
    operations (about ten per input slot and per output slot)."""
    nbytes = (labels.numel() * 5 + 4 * int(valid.sum())
              + sum(o.numel() * o.element_size() for o in outs))
    return nbytes, 10 * (labels.numel() + outs[0].numel())


def lif_inputs(gen, shape):
    """The JAX suite's LIF inputs: v ~ U(-0.5, 1.2), i ~ 0.3 N(0, 1),
    drive ~ U(0, 0.5)."""
    def rnd(*shape_):
        return torch.rand(shape_, generator=gen, device=DEV)
    return (rnd(*shape) * 1.7 - 0.5,
            0.3 * torch.randn(shape, generator=gen, device=DEV),
            0.5 * rnd(*shape))


def lif_check(what, v, i, d):
    """The kernel and the plain version from one state.  Outside spike
    flips, v and i_syn agree within LIF_TOL; a spike may flip only where
    the plain membrane is within LIF_TOL of the threshold.  Returns (max
    abs err, flips, the plain version's (v, i_syn, spikes))."""
    got = lif_ops.lif_step(v, i, d)
    want = lif_step_ref(v, i, d)
    _, v_pre = nrn.membrane(nrn.NeuronState(
        v, i, torch.zeros_like(v), torch.zeros_like(v, dtype=torch.int32)), d)
    torch.cuda.synchronize()
    agree = got[2] == want[2]
    near = (v_pre - nrn.LIF.v_th).abs() < LIF_TOL
    if bool((~agree & ~near).any()):
        raise AssertionError(f"lif_step {what}: a spike flipped away from "
                             f"the threshold")
    err = max(float(torch.where(agree, (g - w).abs(), 0).max())
              for g, w in zip(got[:2], want[:2]))
    if err > LIF_TOL:
        raise AssertionError(f"lif_step {what}: kernel != plain (max abs err "
                             f"{err} > {LIF_TOL})")
    return err, int((~agree).sum()), want


def phase2_interconnect(results: dict) -> None:
    gen = torch.Generator(device=DEV).manual_seed(12)

    # The egress router: the main path's shape (phase 7), a random LUT over
    # labels anywhere in int32, dense rows that overflow cap_in, phase 7's
    # call as it is made (the label grid expanded over the batch and a
    # transposed raster, read in place), then long rows: the row body with
    # one and with two stripes a lane, and the tiled body.
    lead = (BATCH, 120)
    err = 0.0
    main_case = None
    for name, occ, random_lut in (("main path: identity LUT", OCC, False),
                                  ("random LUT, 15% disabled", 0.3, True),
                                  ("dense rows overflow", 0.9, False),
                                  ("phase 7's views, read in place", OCC,
                                   False),
                                  ("3,000 events a row", 0.3, True),
                                  ("6,000 events a row", 0.3, True),
                                  ("8,193 events a row", 0.3, True)):
        cap = EGRESS_CAP
        if "events a row" in name:
            n = int(name.split()[0].replace(",", ""))
            cap = 256
            labels = torch.randint(-(1 << 31), (1 << 31) - 1, (BATCH, 12, n),
                                   generator=gen, device=DEV,
                                   dtype=torch.int32)
            labels[..., ::2] &= 0xFFFF            # a share on mapped entries
            valid = torch.rand(labels.shape, generator=gen, device=DEV) < occ
            table = lut(gen, 1, 1 << 16, 15, 15)[0]
        else:
            labels, valid, table = egress_case(gen, lead, occ, random_lut)
        if "views" in name:
            labels = labels[0, None].expand(labels.shape)
            valid = valid.transpose(0, 1).contiguous().transpose(0, 1)
            if ops.row_layout(labels) is None or ops.row_layout(valid) is None:
                raise AssertionError("spike_router: phase 7's views would be "
                                     "copied")
        got, body = run_counted(
            lambda: ops.route_and_pack(labels, valid, table, capacity=cap),
            ops.route_and_pack.launches_by_path)
        want = ref.spike_router_ref(labels, valid, table, capacity=cap)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        if e:
            raise AssertionError(f"spike_router {name} ({body}): kernel != "
                                 f"plain (max abs err {e})")
        enabled = int(got[1].sum()) + int(got[2].sum())
        disabled = int(valid.sum()) - enabled
        if "overflow" in name and not int(got[2].sum()):
            raise AssertionError(f"spike_router {name}: no overflow")
        if not disabled:
            raise AssertionError(f"spike_router {name}: no disabled events")
        ms = graph_ms(lambda: ops.route_and_pack(labels, valid, table,
                                                 capacity=cap))
        rows, n = valid.numel() // valid.shape[-1], valid.shape[-1]
        floor = spike_router_floor_ms(rows, n, cap, body)
        b_ms, b_by = bound(*router_cost(labels, valid, got))
        print(f"phase 2: spike_router {name}: {tuple(labels.shape)} -> cap "
              f"{cap}, {int(valid.sum())} valid, {disabled} disabled, "
              f"dropped {int(got[2].sum())}, exact; {body} body: kernel "
              f"{ms * 1e3:.2f} us, launch floor {floor * 1e3:.2f} us, bound "
              f"{b_ms * 1e3:.2f} us ({b_by})", flush=True)
        if main_case is None:
            main_case = (labels, valid, table, ms, floor, b_ms, b_by)
        err = max(err, e)
    labels, valid, table, ms, floor, b_ms, b_by = main_case
    results["spike_router"] = dict(
        max_abs_err=err, ms=ms, floor_ms=floor,
        plain_ms=eager_ms(lambda: ref.spike_router_ref(
            labels, valid, table, capacity=EGRESS_CAP)),
        eager_ms=eager_ms(lambda: ops.route_and_pack(
            labels, valid, table, capacity=EGRESS_CAP)),
        bound_ms=b_ms, bound_by=b_by)

    # The streaming exchange: FULL_BACKPLANE's T = 64 x 12 sources x 64
    # egress slots into capacity 256 with its tables (phase 7), then random
    # tables with disabled entries, random enables and dense traffic into a
    # capacity that overflows, then a 33-source star for the tiled body.
    # Each against its plain version and against the exchange kernel with
    # batch = T on the same frames (the same bodies, the row body with one
    # CTA a frame), timed in turns.
    cfg, params, _ = scenarios.engine_network("FULL_BACKPLANE", device=DEV)
    cap_in = next(c[2] for c in scenarios.CASES if c[0] == "FULL_BACKPLANE")
    err = 0.0
    main_case = None
    for name, n, occ, random_luts, cap in (
            ("main path tables", cfg.n_chips, OCC, False, cfg.capacity),
            ("random tables overflow", cfg.n_chips, 0.6, True, 64),
            ("tiled body: 33 sources", 33, 0.3, True, 256)):
        labels = ((torch.arange(n, device=DEV, dtype=torch.int32)[:, None]
                   << 9) + torch.randint(0, 512, (STEPS, n, cap_in),
                                         generator=gen, device=DEV,
                                         dtype=torch.int32))
        valid = torch.rand((STEPS, n, cap_in), generator=gen,
                           device=DEV) < occ
        if random_luts:
            fwd = lut(gen, n, 1 << 16, 15, 15)
            rev = lut(gen, n, 1 << 15, 16, 16)
            enables = torch.rand((n, n), generator=gen, device=DEV) < 0.7
        else:
            fwd, rev, enables = params.router
        args = (labels, valid, fwd, rev, enables)
        got, body = run_counted(
            lambda: ops.fused_exchange_stream(*args, capacity=cap),
            ops.fused_exchange_stream.launches_by_path)
        want = ref.exchange_stream_ref(*args, capacity=cap)
        per_step = ops.fused_exchange(*args, capacity=cap)
        torch.cuda.synchronize()
        e = max(max_abs_err(got, want), max_abs_err(got, per_step))
        if e:
            raise AssertionError(f"exchange_stream {name} ({body}): kernel "
                                 f"!= plain or != exchange (max abs err {e})")
        if random_luts and not int(got[2].sum()):
            raise AssertionError(f"exchange_stream {name}: no overflow")
        ms, ex_ms, ex_ms2, ms2 = (graph_ms(lambda: f(*args, capacity=cap))
                                  for f in (ops.fused_exchange_stream,
                                            ops.fused_exchange,
                                            ops.fused_exchange,
                                            ops.fused_exchange_stream))
        floor = stream_floor_ms(labels, n, cap, body)
        b_ms, b_by = bound(*exchange_cost(labels, valid, enables, got))
        line = (f"phase 2: exchange_stream {name}: T {STEPS} x {n} x {cap_in} "
                f"-> cap {cap}, dropped {int(got[2].sum())}, exact and == "
                f"exchange(batch = T); {body} body: kernel {ms * 1e3:.2f}/"
                f"{ms2 * 1e3:.2f} us (turns 1 and 4), launch floor "
                f"{floor * 1e3:.2f} us, exchange kernel with batch = T "
                f"{ex_ms * 1e3:.2f}/{ex_ms2 * 1e3:.2f} us (turns 2 and 3), "
                f"bound {b_ms * 1e3:.2f} us ({b_by})")
        if body == "row":
            line += (f"; {ops.row_groups(STEPS, n, SMS)} CTAs a timestep (the "
                     f"exchange kernel: one a batch row)")
        print(line, flush=True)
        if main_case is None:
            main_case = (args, cap, ms, floor, b_ms, b_by)
        err = max(err, e)
    args, cap, ms, floor, b_ms, b_by = main_case
    results["exchange_stream"] = dict(
        max_abs_err=err, ms=ms, floor_ms=floor,
        plain_ms=eager_ms(lambda: ref.exchange_stream_ref(*args,
                                                          capacity=cap)),
        eager_ms=eager_ms(lambda: ops.fused_exchange_stream(*args,
                                                            capacity=cap)),
        bound_ms=b_ms, bound_by=b_by)

    # The LIF step: the chips' full width (phase 8), ragged shapes the TPU
    # kernel would pad, and the JAX suite's inputs.
    err, flips = 0.0, 0
    for shape in ((LIF_BATCH * LIF_CHIPS, 512), (5, 300), (3, 7, 11)):
        v, i, d = lif_inputs(gen, shape)
        e, f, _ = lif_check(str(shape), v, i, d)
        err, flips = max(err, e), flips + f
        if shape[-1] == 512:
            main = (v, i, d)
    v, i, d = main
    # The 12 MB a launch moves fit in the 50 MB L2, so launches on one input
    # set read it from the cache.  The kept time cycles through input sets
    # that together exceed the L2, so each launch reads device memory as
    # the byte bound assumes; the warm time is printed beside it.
    sets = itertools.cycle([lif_inputs(gen, v.shape) for _ in range(LIF_SETS)])
    ms = graph_ms(lambda: lif_ops.lif_step(*next(sets)))
    warm_ms = graph_ms(lambda: lif_ops.lif_step(v, i, d))
    print(f"phase 2: lif_step: max abs err {err:.3g} (tolerance {LIF_TOL}), "
          f"{flips} near-threshold spike flips; kernel {ms * 1e3:.2f} us "
          f"over {LIF_SETS} input sets, {warm_ms * 1e3:.2f} us on one (L2 "
          f"warm)", flush=True)
    # Bytes: three float32 inputs read once, three outputs written once;
    # operations: 12 float32 operations per neuron.
    b_ms, b_by = bound(24 * v.numel(), 12 * v.numel())
    floor_launch = launcher("lif_step", "lif_step_floor_launch",
                            (ctypes.c_int64, PTR))
    floor = graph_ms(lambda: check(floor_launch(v.numel(), cuda_stream()),
                                   "lif_step floor"))
    results["lif_step"] = dict(
        max_abs_err=err, ms=ms, floor_ms=floor,
        plain_ms=eager_ms(lambda: lif_step_ref(v, i, d)),
        eager_ms=eager_ms(lambda: lif_ops.lif_step(v, i, d)),
        bound_ms=b_ms, bound_by=b_by)
    for k in ("spike_router", "exchange_stream", "lif_step"):
        r = results[k]
        print(f"phase 2: {k}: kernel {r['ms'] * 1e3:.2f} us (graph replay), "
              f"launch floor {r['floor_ms'] * 1e3:.2f} us, "
              f"{r['eager_ms'] * 1e3:.2f} us as called, plain "
              f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.3f}"
              f" us ({r['bound_by']})", flush=True)


# ---------------------------------------------------------------------------
# Phase 2, the per-slot STDP step
# ---------------------------------------------------------------------------

# The engine's per-slot weights: ext4case.engine's 96 chips x 64 slots, 256
# rows x 512 neurons (3.2 GB of float32).
STDP_SHAPE = (96, 64, 256, 512)


def stdp_inputs(gen, shape):
    """Traces in [0, 3), drives in multiples of 1/16 up to 4 on 30% of the
    rows, spikes on 10% of the neurons, weights in [0, 63) with a fifth on
    0 and a seventh on 63; the mask keeps 4 slots of every 5."""
    c, b, r, n = shape

    def uniform(size, hi):
        return torch.rand(size, generator=gen, device=DEV) * hi

    pre = ((uniform((c, b, r), 1.0) < 0.3) * torch.randint(
        1, 64, (c, b, r), generator=gen, device=DEV) / 16).float()
    post = (uniform((c, b, n), 1.0) < 0.1).float()
    w = uniform((c, b, r, n), 63.0)
    flat = w.view(-1)
    flat[::5] = 0.0
    flat[3::7] = 63.0
    state = plas.SlotPlasticityState(uniform((c, b, r), 3.0),
                                     uniform((c, b, n), 3.0), w)
    return state, pre, post, torch.arange(b, device=DEV) % 5 != 4


def stdp_check(what: str, state, pre, post, mask) -> tuple[float, int]:
    """The kernel against its plain version on the same card inputs: traces
    and weights bit for bit, except where a float64 sum of the plain
    version lands on a float32 rounding midpoint (``stdp_ref.midpoints``,
    one chip at a time where values differ).  Returns (max abs difference,
    values that differ)."""
    with torch.no_grad():
        got = stdp_ops.stdp_slot(state, pre, post, STDP, mask)
        want = stdp_ref.stdp_slot_ref(state, pre, post, STDP, mask)
    err, n_diff = 0.0, 0
    for field in plas.SlotPlasticityState._fields:
        g, w = getattr(got, field), getattr(want, field)
        differ = g.view(torch.int32) != w.view(torch.int32)
        n_diff += int(differ.sum())
        err = max(err, float((g - w).abs().max()))
        for c in differ.flatten(1).any(1).nonzero().flatten().tolist():
            one = slice(c, c + 1)
            mids = stdp_ref.midpoints(
                plas.SlotPlasticityState(*(x[one] for x in state)),
                pre[one], post[one], STDP, mask)[field]
            bad = (differ[one] & ~mids).nonzero()
            if len(bad):
                at = (c, *bad[0].tolist()[1:])
                raise AssertionError(
                    f"stdp_slot {what}: {field}{list(at)} kernel "
                    f"{g[at].item()!r}, plain {w[at].item()!r}, not on a "
                    f"float32 rounding midpoint")
    return err, n_diff


def phase2_stdp(results: dict) -> None:
    gen = torch.Generator(device=DEV).manual_seed(37)
    state, pre, post, mask = stdp_inputs(gen, STDP_SHAPE)
    inputs = [x.clone() for x in (*state, pre, post)]
    err, n_diff = 0.0, 0
    for what, m in (("unmasked", None), ("masked", mask)):
        e, n = stdp_check(what, state, pre, post, m)
        err, n_diff = max(err, e), n_diff + n
    for x, y in zip(inputs, (*state, pre, post), strict=True):
        parity.assert_equal("stdp_slot: its inputs after the launches", x, y)
    del inputs
    with torch.no_grad():
        ms = {what: eager_ms(lambda m=m: stdp_ops.stdp_slot(
            state, pre, post, STDP, m)) for what, m in (("unmasked", None),
                                                        ("masked", mask))}
        plain = eager_ms(lambda: stdp_ref.stdp_slot_ref(state, pre, post,
                                                        STDP, mask),
                         iters=3, warmup=1)
    c, b, r, n = STDP_SHAPE
    # Bytes: the weights read once and written once, the traces read and
    # written, the drives and spikes read; 7 float32 operations a synapse.
    b_ms, b_by = bound(8 * c * b * r * n + 4 * c * b * (3 * r + 3 * n) + b,
                       7 * c * b * r * n)
    # The engine passes its slot mask at every step: the masked time is
    # the main path's.
    results["stdp_slot"] = dict(
        max_abs_err=err, ms=ms["masked"], plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by)
    print(f"phase 2: stdp_slot {list(STDP_SHAPE)}: the kernel against its "
          f"plain version, unmasked and with {int(mask.sum())} of {b} slots "
          f"kept: {n_diff} values differ (each on a float32 rounding "
          f"midpoint), max abs err {err:.3g}; inputs unchanged; kernel "
          f"{ms['unmasked']:.4f} ms unmasked, {ms['masked']:.4f} ms masked "
          f"(as called, CUDA events), plain {plain:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    del state, pre, post, mask
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 2, LM kernels: flash attention and the linear scan
# ---------------------------------------------------------------------------

# One bf16 ulp, relative: both sides round an f32 result to bf16.
BF16_ULP = 2.0 ** -7


def check_close(what: str, got, want, rel: float, abs_tol: float,
                reason: str, phase: str = "2") -> float:
    """Elementwise |got - want| <= rel·|want| + abs_tol, finite; prints the
    max abs error beside the tolerance and its reason, raises if exceeded."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = float(diff.max())
    excess = float((diff - rel * want.abs()).max())
    ok = bool(torch.isfinite(got).all()) and excess <= abs_tol
    print(f"phase {phase}: {what}: max abs err {err:.3g} (max |ref| "
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


def flash_bound(q, k, v, causal: bool = True) -> tuple[float, str]:
    """Attention's bound: q, k, v read once and the output (v's head dim)
    written once; Q·Kᵀ at q's head dim and P·V at v's over the pairs a
    query attends to (the causal half, or all of them), at the bf16
    tensor-core rate."""
    b, h, sq, d = q.shape
    skv, dv = k.shape[2], v.shape[-1]
    pairs = sq * (sq + 1) // 2 if causal else sq * skv
    nbytes = (sum(map(unique_bytes, (q, k, v)))
              + b * h * sq * dv * q.element_size())
    return bound(nbytes, 2 * b * h * (d + dv) * pairs, BF16_OPS_PER_S)


def scan_bound(q, k, v, w, u=None) -> tuple[float, str]:
    """The scan's bound: the distinct bytes of q, k, v, w (and u) read once
    and y written once; the chunked form's multiply-adds per chunk
    (inter-chunk and carry products, and the causal half of A and of
    A @ V), at the bf16 tensor-core rate."""
    kdim, vdim = q.shape[-1], v.shape[-1]
    bsz, heads, t = q.shape[:3]
    chunk = scan_ops.chunk_for(t)
    nbytes = (sum(unique_bytes(a) for a in (q, k, v, w, u) if a is not None)
              + v.numel() * q.element_size())
    per_chunk = 2 * (2 * chunk * kdim * vdim
                     + chunk * (chunk + 1) // 2 * (kdim + vdim))
    return bound(nbytes, bsz * heads * -(-t // chunk) * per_chunk,
                 BF16_OPS_PER_S)


def flash_inputs(gen, b, hq, hkv, s, d, dtype, v_view=False):
    """q, k, v at [b, heads, s, d]; with ``v_view`` v is the transposed
    view of a [b, s, heads, d] tensor, as ``gqa_forward``'s ``_split_heads``
    hands it to the kernel."""
    def rnd(h):
        return torch.randn((b, h, s, d), generator=gen, device=DEV).to(dtype)
    v = (torch.randn((b, s, hkv, d), generator=gen, device=DEV).to(dtype)
         .transpose(1, 2) if v_view else rnd(hkv))
    return rnd(hq), rnd(hkv), v


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


def rwkv_inputs(gen, b, h, t, kd, dtype, views=False):
    """Bonus-mode operands at RWKV6's shapes: per-channel data-dependent
    decays w = -exp(base + noise), base from -6 to -0.5 across channels,
    and a bonus u.  With ``views`` the same values are laid out as
    ``rwkv6_time_mix`` hands them to the kernel: [b, t, h, kd] tensors seen
    as [b, h, t, kd], and w rounded to ``dtype``."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=DEV)
    base = torch.linspace(-6.0, -0.5, h * kd, device=DEV).reshape(h, kd)
    w = -torch.exp(base[None, :, None, :] + 0.5 * rnd(b, h, t, kd))
    q, k, v = (rnd(b, h, t, kd).to(dtype), (0.5 * rnd(b, h, t, kd)).to(dtype),
               rnd(b, h, t, kd).to(dtype))
    u = 0.5 * rnd(h, kd)
    if views:
        q, k, v, w = (a.transpose(1, 2).contiguous().transpose(1, 2)
                      for a in (q, k, v, w.to(dtype)))
    return q, k, v, w, u


def strong_inputs(gen, b, h, t, kd, dtype):
    """Operands with decays uniform down to e^-10 a step (the cumsum
    reaches about -320 within a chunk), k halved, and a bonus u."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=DEV)
    q, k, v = rnd(b, h, t, kd), 0.5 * rnd(b, h, t, kd), rnd(b, h, t, kd)
    w = -10 * torch.rand((b, h, t, kd), generator=gen, device=DEV)
    return (*(a.to(dtype) for a in (q, k, v, w)), 0.5 * rnd(h, kd))


def one_body(fn, counts: dict, body: str):
    """Runs ``fn`` and checks that it launched once, through ``body``."""
    before = dict(counts)
    out = fn()
    if counts != {**before, body: before[body] + 1}:
        raise AssertionError(f"expected one {body} launch, counts went "
                             f"{before} -> {counts}")
    return out


F32_REASON = "float32 sums in another order than the plain version"
BF16_REASON = ("bf16 output, one ulp apart where the two f32 results round "
               "apart")
# The wgmma body rounds P to bf16 (as the Pallas body's p.astype(v.dtype)
# does on the TPU's MXU).  Against attention_ref, which keeps P in f32, each
# weight moves by at most half a bf16 ulp (2^-8 of itself) and l sums the
# unrounded weights: the output moves by at most 2^-8·max|v|.  Against the
# blocked twin, which rounds P too, a weight whose f32 value differs in the
# last bits between the two sides' score sums may round one ulp apart; the
# same bound holds, and at most FLIP_SHARE of the outputs may leave the
# bf16 output tolerance above.
P_REASON = "P rounded to bf16 (2^-8·max|v|) and one bf16 ulp of output"
FLIP_SHARE = 1e-3
SCAN_TC_REASON = ("bf16 output one ulp apart, TF32 products, __expf and sums "
                  "in another order (1e-3 of the output's scale)")
SCAN_F32_REASON = ("__expf and float32 sums and cumsums in another order "
                   "(1e-3 of the output's scale)")


def flash_check(name: str, q, k, v, causal: bool, body: str,
                phase: str = "2") -> float:
    """One flash-attention launch, which must take ``body``, against
    attention_ref and (bf16) against the body's plain twin (``ops.twin``:
    attention_blocked_ref at the wgmma body's KV tile, attention_split_ref
    at the decode body's splits), within the tolerances above.  Returns the
    max abs error."""
    counts = flash_ops.flash_attention.launches_by_path
    got = one_body(lambda: flash_ops.flash_attention(q, k, v, causal=causal),
                   counts, body)
    want = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if body == "f32":
        return check_close(f"flash_attention {name}", got, want, 0.0, 2e-5,
                           F32_REASON, phase)
    p_tol = 2.0 ** -8 * float(v.float().abs().max())
    err = check_close(f"flash_attention {name} vs attention_ref", got, want,
                      BF16_ULP, p_tol, P_REASON, phase)
    del want
    twin = flash_ops.twin(q, k, v, causal=causal)
    twin_name = ("attention_split_ref" if body == "decode"
                 else "attention_blocked_ref")
    err = max(err, check_close(
        f"flash_attention {name} vs {twin_name}", got, twin, BF16_ULP,
        p_tol, P_REASON, phase))
    diff = (got.float() - twin.float()).abs()
    over = int((diff > BF16_ULP * twin.float().abs() + 1e-5).sum())
    print(f"phase {phase}: flash_attention {name}: {over} of {got.numel()} "
          f"outputs beyond {BF16_ULP:.3g}·|twin| + 1e-5 ({BF16_REASON}; "
          f"at most {FLIP_SHARE:.0e} of them may be, where a bf16 P rounds "
          f"apart)", flush=True)
    if over > FLIP_SHARE * got.numel():
        raise AssertionError(f"flash_attention {name}: {over} outputs "
                             f"beyond the bf16 tolerance")
    return err


def flash_ms(q, k, v, causal: bool) -> float:
    """Device time per flash-attention call (CUDA-graph replay)."""
    return graph_ms(lambda: flash_ops.flash_attention(q, k, v, causal=causal),
                    10, 5)


def flash_kernel(q, k, v) -> str:
    """The body a call takes, and for the wgmma body its kernel and tile."""
    body = flash_ops.body_for(q, k, v)
    if body == "decode":
        n = flash_ops.decode_splits(q.shape[0] * q.shape[1], k.shape[2])
        return (f"decode, {n} splits of {flash_ops.DECODE_BLOCK_KV}-key "
                f"blocks, {n * q.shape[0] * q.shape[1]} blocks")
    if body == "wgmma":
        return f"wgmma, {flash_ops.block_kv_for(q.shape[-1])}-key tiles"
    return body


def scan_check(name: str, args, mode: str, body: str, tol,
               phase: str = "2") -> float:
    """One linear-scan launch, which must take ``body``, against
    linear_scan_chunked (and the tensor-core bodies' twins), within
    ``tol`` = (rel, abs as a share of max|ref|, reason).  Returns the max
    abs error."""
    rel, abs_rel, reason = tol
    got = one_body(lambda: scan_ops.linear_scan(*args, mode=mode),
                   scan_ops.linear_scan.launches_by_path, body)
    chunk = scan_ops.chunk_for(args[0].shape[2])
    wants = {"linear_scan_chunked": linear_scan_chunked(
        *args, mode=mode, chunk=chunk)}
    if body == "scalar_decay":
        wants["linear_scan_scalar_decay_ref"] = \
            linear_scan_scalar_decay_ref(*args[:4])
    elif body == "channel_decay":
        wants["linear_scan_channel_decay_ref"] = \
            linear_scan_channel_decay_ref(*args, mode=mode)
    torch.cuda.synchronize()
    err = 0.0
    for ref_name, want in wants.items():
        want = want.to(got.dtype)
        abs_tol = abs_rel * float(want.float().abs().max())
        err = max(err, check_close(
            f"linear_scan {name} ({body}) vs {ref_name}", got, want, rel,
            abs_tol, reason, phase))
    return err


def phase2_lm(results: dict) -> None:
    gen = torch.Generator(device=DEV).manual_seed(7)
    bf16, f32 = torch.bfloat16, torch.float32

    # Flash attention.  (case, (b, hq, hkv, s, d, dtype, v_view), causal,
    # body)
    flash_cases = (
        ("main path: b4 h32 s2048 d112 bf16 causal (v a transposed view)",
         (4, 32, 32, 2048, 112, bf16, True), True, "wgmma"),
        ("GQA group 4: b2 h32/8 s1024 d128 bf16 causal",
         (2, 32, 8, 1024, 128, bf16, False), True, "wgmma"),
        ("ragged s2000: b1 h8 d112 bf16 causal",
         (1, 8, 8, 2000, 112, bf16, False), True, "wgmma"),
        ("d256, 80-key tiles: b1 h4/2 s1000 bf16 not causal",
         (1, 4, 2, 1000, 256, bf16, False), False, "wgmma"),
        ("gemma-7b's shape at batch 1: b1 h16 s2048 d256 bf16 causal",
         (1, 16, 16, 2048, 256, bf16, False), True, "wgmma"),
        ("d192, 112-key tiles: b1 h8/2 s1000 bf16 causal",
         (1, 8, 2, 1000, 192, bf16, False), True, "wgmma"),
        ("f32: b2 h8 s1024 d112 causal", (2, 8, 8, 1024, 112, f32, False),
         True, "f32"),
        ("f32: b1 h4/2 s1000 d64 not causal", (1, 4, 2, 1000, 64, f32, False),
         False, "f32"),
    )
    err = 0.0
    for i, (name, shape, causal, body) in enumerate(flash_cases):
        q, k, v = flash_inputs(gen, *shape)
        err = max(err, flash_check(name, q, k, v, causal, body))
        if i == 0:
            main = (q, k, v)
    # The decode body: whisper's decode cross-attention (one query row
    # against 1500 frames, q, k, v transposed [b, s, h, d] views), a GQA
    # call of 16 rows against ragged keys, and serve_lm's causal smoke
    # prefill (s16, d16).
    decode_cases = (
        ("decode: whisper cross-attention b4 h16 q1 kv1500 d64 (views)",
         (heads_view(gen, 4, 16, 1, 64, bf16),
          heads_view(gen, 4, 16, 1500, 64, bf16),
          heads_view(gen, 4, 16, 1500, 64, bf16)), False),
        ("decode: GQA group 4, b2 h16/4 q16 kv1000 d128",
         (heads_view(gen, 2, 16, 16, 128, bf16),
          heads_view(gen, 2, 4, 1000, 128, bf16),
          heads_view(gen, 2, 4, 1000, 128, bf16)), False),
        ("decode: causal b4 h4/1 s16 d16 (serve_lm's smoke prefill)",
         flash_inputs(gen, 4, 4, 1, 16, 16, bf16, True), True),
    )
    for name, (dq, dk, dv), causal in decode_cases:
        err = max(err, flash_check(name, dq, dk, dv, causal, "decode"))
        sdpa = graph_ms(lambda: F.scaled_dot_product_attention(
            dq, dk, dv, is_causal=causal, enable_gqa=True), 10, 5)
        print(f"phase 2: flash_attention {name} ({flash_kernel(dq, dk, dv)})"
              f": kernel {flash_ms(dq, dk, dv, causal):.4f} ms (graph "
              f"replay), SDPA {sdpa:.4f} ms, bound "
              f"{flash_bound(dq, dk, dv, causal)[0]:.4f} ms [{card()}]",
              flush=True)
    del decode_cases, dq, dk, dv
    q, k, v = main
    scale = 1.0 / q.shape[-1] ** 0.5
    b_ms, b_by = flash_bound(q, k, v)
    q32, k32, v32 = q.float(), k.float(), v.float()
    results["flash_attention"] = dict(
        max_abs_err=err,
        ms=graph_ms(lambda: flash_ops.flash_attention(q, k, v), 10, 5),
        plain_ms=eager_ms(lambda: flash_ops.twin(q, k, v), 2, 1),
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True), 10, 5),
        bound_ms=b_ms, bound_by=b_by,
        other=("f32 body on float32 operands", graph_ms(
            lambda: flash_ops.flash_attention(q32, k32, v32), 2, 1)))
    del main, q, k, v, q32, k32, v32

    # Linear scan.  (case, make inputs, mode, body, tolerance)
    tc_reason = SCAN_TC_REASON

    def dense_w(args):
        q, k, v, w, u = args
        return q, k, v, w.contiguous(), u

    scan_cases = (
        ("main path: mamba2 b4 h112 t2048 k64 v64 bf16 inclusive",
         lambda: mamba_inputs(gen, 4, 112, 2048, 64, 64, bf16), "inclusive",
         "scalar_decay", (BF16_ULP, 1e-3, tc_reason)),
        ("ragged t1000: mamba2 b2 h16 bf16 inclusive",
         lambda: mamba_inputs(gen, 2, 16, 1000, 64, 64, bf16), "inclusive",
         "scalar_decay", (BF16_ULP, 1e-3, tc_reason)),
        ("channel-decay body on mamba2's operands, w dense: b2 h16 t1000 "
         "bf16", lambda: dense_w(mamba_inputs(gen, 2, 16, 1000, 64, 64, bf16)),
         "inclusive", "channel_decay", (BF16_ULP, 1e-3, tc_reason)),
        ("bonus: rwkv6 b2 h64 t1024 k64 v64 bf16",
         lambda: rwkv_inputs(gen, 2, 64, 1024, 64, bf16), "bonus",
         "channel_decay", (BF16_ULP, 1e-3, tc_reason)),
        ("ragged t1000 bonus: rwkv6 b2 h16 k64 v64 bf16 views",
         lambda: rwkv_inputs(gen, 2, 16, 1000, 64, bf16, views=True),
         "bonus", "channel_decay", (BF16_ULP, 1e-3, tc_reason)),
        ("strong decays up to e^-10 per step: b1 h8 t512 k64 v64 bf16 bonus",
         lambda: strong_inputs(gen, 1, 8, 512, 64, bf16), "bonus",
         "channel_decay", (BF16_ULP, 1e-3, tc_reason)),
        ("per-channel body, f32 bonus: rwkv6 b2 h64 t1024 k64 v64",
         lambda: rwkv_inputs(gen, 2, 64, 1024, 64, f32), "bonus",
         "per_channel", (0.0, 1e-3, SCAN_F32_REASON)),
        ("per-channel body on bf16 operands, K = V = 40: rwkv6 b2 h16 t1000 "
         "bonus", lambda: rwkv_inputs(gen, 2, 16, 1000, 40, bf16), "bonus",
         "per_channel",
         (BF16_ULP, 1e-3, "bf16 output one ulp apart; " + SCAN_F32_REASON)),
        ("strong decays up to e^-10 per step: b1 h8 t512 f32 inclusive",
         lambda: strong_inputs(gen, 1, 8, 512, 64, f32)[:4] + (None,),
         "inclusive", "per_channel",
         (0.0, 1e-3, "__expf and float32 cumsums in another order at "
          "|b| ~ 300 (1e-3 of the output's scale)")),
    )
    err = 0.0
    for i, (name, make, mode, body, tol) in enumerate(scan_cases):
        args = make()
        err = max(err, scan_check(name, args, mode, body, tol))
        if i == 0:
            main = args
        del args
    q, k, v, w, _ = main
    b_ms, b_by = scan_bound(q, k, v, w)
    w_dense = w.contiguous()
    results["linear_scan"] = dict(
        max_abs_err=err,
        ms=graph_ms(lambda: scan_ops.linear_scan(q, k, v, w), 10, 5),
        plain_ms=eager_ms(lambda: linear_scan_scalar_decay_ref(q, k, v, w),
                          2, 1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        other=("channel-decay body (w dense)", graph_ms(
            lambda: scan_ops.linear_scan(q, k, v, w_dense), 2, 1)))
    del main, q, k, v, w, w_dense
    for name in ("flash_attention", "linear_scan"):
        r = results[name]
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"phase 2: {name} main-path shape: kernel {r['ms']:.4f} ms "
              f"(graph replay), plain {r['plain_ms']:.4f} ms, library {lib}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
              f"{r['other'][0]} {r['other'][1]:.4f} ms", flush=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Helpers of the SNN phases (3, 9, 10, 12): drives, counted runs, turns
# ---------------------------------------------------------------------------

STREAM_FIELDS = ("spikes", "dropped", "uplink_dropped", "latency_ns",
                 "latency_valid", "unroutable", "rerouted")


def main_drives(cfg) -> torch.Tensor:
    """Phase 3's external drives for ``cfg``'s network."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    return (torch.rand((STEPS, cfg.n_chips, BATCH, cfg.chip.n_rows),
                       generator=gen, device=DEV) < DRIVE_P).to(torch.float32)


def leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in leaves(t)]


def assert_same_stream(what: str, a, b) -> None:
    """Two ``StreamOut``s equal bit for bit, final state included."""
    for f in STREAM_FIELDS:
        parity.assert_equal(f"{what} {f}", getattr(a, f), getattr(b, f))
    for x, y in zip(leaves(a.state), leaves(b.state), strict=True):
        parity.assert_equal(f"{what} state", x, y)


def counted(fn):
    """``fn()`` with the SNN kernels' counts set to 0 just before: returns
    (its result, wall seconds to the card's end, launches by body)."""
    torch.cuda.synchronize()
    reset_snn_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {k: v for k, v in snn_paths().items() if v}


def expect_bodies(what: str, paths: dict, want: dict,
                  launches: dict) -> None:
    """Fails unless the run launched exactly ``want`` by body; adds its
    launches to the main path's counts."""
    if paths != want:
        raise AssertionError(f"{what}: launches by body {paths}, expected "
                             f"{want}")
    for k, v in paths.items():
        launches[k.split()[0]] += v


def host_syncs(fn) -> int:
    """How many synchronising CUDA operations ``fn()`` issues (CUDA's sync
    debug mode, counted as its warnings; explicit synchronisation is not
    counted)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def in_turns(runs: dict, launches: dict, want: dict,
             rounds: int = 1, steps: int = STEPS) -> tuple[dict, dict]:
    """Runs ``runs`` (name -> fn) as A B B A, ``rounds`` times over, each
    run of ``steps`` steps checked to launch ``want[name]`` by body.
    Returns (last output, steps/s list in run order) by name."""
    outs, rates = {}, {k: [] for k in runs}
    a, b = runs
    for name in (a, b, b, a) * rounds:
        outs[name], wall, paths = counted(runs[name])
        expect_bodies(name, paths, want[name], launches)
        rates[name].append(steps / wall)
    return outs, rates


# ---------------------------------------------------------------------------
# Phase 3: the main path at full width
# ---------------------------------------------------------------------------


def phase3(launches: dict, gpu: str) -> dict:
    """Returns each run's steps/s and spikes, keyed by (scenario, exchange
    mode, timed): the healthy runs phase 9 holds its faulted ones
    against."""
    healthy = {}
    for name, mode, timed in MAIN_PATHS:
        cfg, params, plan = scenarios.engine_network(name, device=DEV)
        plan = fablib.with_exchange_mode(plan, mode)
        state = netlib.init_state(cfg, BATCH, device=DEV)
        drives = main_drives(cfg)

        def run(d=drives, p=params, s=state, c=cfg, pl=plan, tm=timed):
            return stream.run_stream(p, s, d, c, fabric=pl, timed=tm,
                                     device=DEV)

        run(drives[:4])                                     # warm-up
        out, wall, paths = counted(run)
        expect_bodies(f"{name}/{mode}", paths,
                      main_bodies(plan, mode, timed), launches)
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
                f"{int(out.uplink_dropped.sum())}, launches by body "
                f"{paths}")
        if timed:
            stats = stream.stream_latency_stats(out)
            line += (f", delivered {stats['count'] / wall:.4g} events/s, "
                     f"latency median {stats['median_ns']:.0f} ns, p99 "
                     f"{stats['p99_ns']:.0f} ns")
        print(line + f" [{gpu}]", flush=True)
        print(f"phase 3: {name}/{mode}: "
              + device_breakdown(lambda: run(drives[:PROFILE_STEPS]))
              + f" [{gpu}]", flush=True)
        healthy[(name, mode, timed)] = (STEPS / wall, out.spikes)
    return healthy


def main_bodies(plan, mode: str, timed: bool) -> dict:
    """The launches by body of a healthy STEPS-step run: the exchange
    kernel's row body on a 1-level untimed gather plan, merge_pack's warp
    body otherwise."""
    if plan.n_levels == 1 and not timed and mode == "gather":
        return {"exchange row": STEPS}
    return {"merge_pack warp": STEPS}


def snn_paths() -> dict:
    return {**{f"exchange {k}": v
               for k, v in ops.fused_exchange.launches_by_path.items()},
            **{f"merge_pack {k}": v
               for k, v in ops.fused_merge_pack.launches_by_path.items()}}


def reset_counts(wrapper) -> None:
    """Sets a kernel wrapper's launch counts, in all and by body, to 0."""
    wrapper.launches = 0
    for body in wrapper.launches_by_path:
        wrapper.launches_by_path[body] = 0


def reset_snn_counts() -> None:
    reset_counts(ops.fused_merge_pack)
    reset_counts(ops.fused_exchange)


def device_breakdown(fn, per: int = PROFILE_STEPS, unit: str = "step",
                     ours: tuple = ("merge_pack", "exchange_row",
                                    "exchange_tiled")) -> str:
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
        print(f"phase 4: {card_vs_cpu(name, mode, timed)}", flush=True)


def card_vs_cpu(name: str, mode: str, timed: bool, faults=None,
                fault_mode: str = "mask", dt_us: float | None = None,
                flag: bool = False, overlap: bool = False,
                plastic: str | None = None) -> str:
    """The port on the card against the port on the CPU over CHECK_STEPS
    steps (dyadic weights and drives; the integer outputs equal up to
    near-threshold flips), then the exchange stage under teacher forcing
    with each step's plan and overlay, bit for bit.  ``dt_us`` overrides
    the step, ``flag`` runs the 2-level plan through the hierarchical
    topology flag instead of ``fabric=``; ``plastic`` (``"shared"`` or
    ``"slot"``) runs online plasticity with CHECK_MASK, the flips judged
    on each step's evolving weights and the final traces and weights held
    within ``parity.PLASTICITY_ATOL``.  Returns the report."""
    nets = {}
    for side, dev in (("cpu", torch.device("cpu")), ("card", DEV)):
        # The same seed gives the same network on both devices.
        cfg, params, plan = scenarios.engine_network(name, device=dev)
        if dt_us is not None:
            cfg = dataclasses.replace(cfg, dt_us=dt_us)
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
    kw = dict(faults=faults, fault_mode=fault_mode, overlap=overlap)

    def topology(pl, dev):
        return hierarchical_flag(pl, dev) if flag else dict(fabric=pl)

    def plasticity(p, steps):
        """The plastic runs' arguments over the first ``steps`` steps."""
        if plastic is None:
            return {}
        init = (netlib.init_slot_plasticity if plastic == "slot"
                else netlib.init_stream_plasticity)
        return dict(plasticity=plas.STDPConfig(),
                    plasticity_state=init(p, BATCH),
                    slot_mask=CHECK_MASK[:steps])

    runs = {side: stream.run_stream(p, state, drives, cfg, timed=timed,
                                    device=dev, **topology(pl, dev), **kw,
                                    **plasticity(p, CHECK_STEPS))
            for side, (p, pl, dev) in nets.items()}
    cpu_params, cpu_plan, _ = nets["cpu"]

    def margin_at(t):
        if not t:
            return parity.spike_margin(
                cpu_params, state, drives[0], cfg,
                plasticity(cpu_params, 0).get("plasticity_state",
                                              cpu_params.chips).weights)
        before = stream.run_stream(cpu_params, state, drives[:t], cfg,
                                   device="cpu", **topology(cpu_plan, "cpu"),
                                   **kw, **plasticity(cpu_params, t))
        return parity.spike_margin(
            cpu_params, before.state, drives[t], cfg,
            None if before.plasticity is None else before.plasticity.weights)

    report = parity.compare_streams(runs["cpu"], runs["card"], margin_at)
    # Teacher forcing: both devices route the CPU run's own spikes, step by
    # step with that step's plan and overlay.
    timing = timed_wire(cfg.latency) if timed else None
    forced = {}
    for side, (p, pl, dev) in nets.items():
        plans, sched = stream.fault_segments(pl, faults, fault_mode,
                                             CHECK_STEPS, dev)
        forced[side] = [stream.exchange_spikes(
            p, runs["cpu"].spikes[t].to(dev), cfg, plans[t], timing,
            None if sched is None else stream.health_at(sched, t))
            for t in range(CHECK_STEPS)]
    for t, (on_cpu, on_card) in enumerate(zip(forced["cpu"],
                                              forced["card"])):
        for field, a, b in zip(("drives", "dropped", "uplink", "latency_ns",
                                "latency_valid", "unroutable", "rerouted"),
                               on_cpu, on_card):
            parity.assert_equal(f"{name} step {t} teacher-forced {field}",
                                a, b)
    spk = int(runs["cpu"].spikes.sum())
    if spk == 0:
        raise AssertionError(f"{name}: no spikes to compare")
    lost = int(runs["cpu"].unroutable.sum())
    if faults and not lost:
        raise AssertionError(f"{name}/{fault_mode}: the faults lost nothing")
    what = ""
    if faults is not None:
        what = (f"/{fault_mode} faults ({lost} lost, "
                f"{int(runs['cpu'].rerouted.sum())} rerouted)")
    if flag:
        what += "/hierarchical flag"
    if overlap:
        what += f"/overlap (delay {cfg.delay_steps})"
    if plastic:
        what += (f"/{plastic} plasticity with slots 4-7 masked over steps "
                 f"4-11 (plasticity state max err "
                 f"{report.get('plasticity_max_err')})")
    return (f"{name}/{mode}/{'timed' if timed else 'untimed'}{what}: card "
            f"== CPU over {CHECK_STEPS} steps ({spk} spikes, "
            f"{len(report['flips'])} near-threshold flips "
            f"{report['flips'][:5]}, final state max err "
            f"{report['state_max_err']}); teacher-forced exchange bit-exact")


# ---------------------------------------------------------------------------
# Phase 5: the LM main path, zamba2-7b serving at full width and depth
# ---------------------------------------------------------------------------


def lm_counts() -> dict:
    return {"flash_attention": flash_ops.flash_attention.launches,
            "linear_scan": scan_ops.linear_scan.launches}


def lm_paths() -> dict:
    return {**flash_ops.flash_attention.launches_by_path,
            **scan_ops.linear_scan.launches_by_path}


def reset_lm_counts() -> None:
    reset_counts(flash_ops.flash_attention)
    reset_counts(scan_ops.linear_scan)


def count_lm_bodies(launches: dict) -> None:
    """Adds the LM kernels' launches by body since the last reset to
    ``launches`` (as "linear_scan <body>", "flash_attention <body>"), for
    the kernels line."""
    for name, wrapper in (("linear_scan", scan_ops.linear_scan),
                          ("flash_attention", flash_ops.flash_attention)):
        for body, n in wrapper.launches_by_path.items():
            key = f"{name} {body}"
            launches[key] = launches.get(key, 0) + n


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
    reset_lm_counts()
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
    # Every prefill launch goes through the tensor-core bodies.
    paths = lm_paths()
    want_paths = {"decode": 0, "wgmma": 2 * groups, "f32": 0,
                  "scalar_decay": 2 * cfg.n_layers, "channel_decay": 0,
                  "per_channel": 0}
    if paths != want_paths:
        raise AssertionError(f"zamba2-7b generate: bodies {paths}, expected "
                             f"{want_paths}")
    launches.update(counts)
    count_lm_bodies(launches)
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
          f"resident before the call), launches {counts}, by body {paths} "
          f"[{gpu}]", flush=True)

    reset_lm_counts()
    out = {}

    def one_prefill():
        out["logits"], out["caches"], _ = lm.prefill(
            params, {"tokens": prompts}, cfg)

    print("phase 5: prefill: " + device_breakdown(
        one_prefill, per=1, unit="prefill",
        ours=("attn_", "scan_scalar_decay_kernel")) + f" [{gpu}]",
        flush=True)
    logits = out["logits"]
    dec = serve._splice_prefill(
        cfg, lm.init_cache(cfg, LM_BATCH, LM_PROMPT + 1, DEV),
        out.pop("caches"), LM_PROMPT)
    tok = torch.argmax(logits, -1).to(torch.int32)
    print("phase 5: decode: " + device_breakdown(
        lambda: lm.decode_step(params, tok, dec, LM_PROMPT, cfg), per=1,
        unit="decode step",
        ours=("attn_", "scan_scalar_decay_kernel"))
        + f" [{gpu}]", flush=True)
    if tuple(logits.shape) != (LM_BATCH, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} finite="
                             f"{bool(torch.isfinite(logits).all())}")
    if lm_paths() != {"decode": 0, "wgmma": groups, "f32": 0,
                      "scalar_decay": cfg.n_layers, "channel_decay": 0,
                      "per_channel": 0}:
        raise AssertionError(f"one prefill launched {lm_paths()}")
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
    reset_lm_counts()
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
    # float32 operands take the CUDA-core bodies: TF32 products would break
    # the 1e-3 logit tolerance.
    paths = lm_paths()
    if paths["wgmma"] or paths["decode"] or paths["scalar_decay"] \
            or paths["channel_decay"] \
            or not (paths["f32"] and paths["per_channel"]):
        raise AssertionError(f"phase 6 float32 run went through {paths}")
    print(f"phase 6: zamba2-7b full width, {CHECK_LAYERS} layers, float32, "
          f"batch {CHECK_BATCH} x prompt {CHECK_PROMPT}: card == CPU; "
          f"prefill logits max abs err {errs[0]:.3g}, decode-step logits "
          f"{errs[1]:.3g} (tolerance {CHECK_LOGIT_TOL}, logits up to "
          f"{float(res['cpu'][0].abs().max()):.3g}); {CHECK_NEW} greedy "
          f"tokens equal {res['cpu'][2].tolist()}; bodies {paths}",
          flush=True)
    del sides
    gc.collect()
    torch.cuda.empty_cache()



# ---------------------------------------------------------------------------
# Phase 7: the interconnect path (streaming exchange, egress router)
# ---------------------------------------------------------------------------


def phase7(launches: dict, gpu: str) -> None:
    # The plain star's streaming exchange against its per-step loop.
    cfg, params, _ = scenarios.engine_network("FULL_BACKPLANE", device=DEV)
    cap_in = next(c[2] for c in scenarios.CASES if c[0] == "FULL_BACKPLANE")
    router = params.router
    gen = torch.Generator(device=DEV).manual_seed(13)
    spikes = torch.rand((STEPS, cfg.n_chips, cfg.chip.n_neurons),
                        generator=gen, device=DEV) < OCC
    labels = stream.egress_label_grid(cfg, DEV).expand(spikes.shape)
    frames, _ = make_frame(labels, None, spikes, cap_in)    # [T, 12, 64]

    def run_stream_engine():
        return ops.fused_exchange_stream(
            frames.labels, frames.valid, router.fwd_tables,
            router.rev_tables, router.route_enables, capacity=cfg.capacity)

    def run_loop():
        return [agg.route_step(router, type(frames)(*(x[t] for x in frames)),
                               cfg.capacity) for t in range(STEPS)]

    run_stream_engine(), run_loop()                         # warm-up
    torch.cuda.synchronize()
    reset_counts(ops.fused_exchange_stream)
    t0 = time.perf_counter()
    out_l, out_v, dropped = run_stream_engine()
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    stream_paths = dict(ops.fused_exchange_stream.launches_by_path)
    if ops.fused_exchange_stream.launches != 1 or stream_paths["row"] != 1:
        raise AssertionError(f"stream: {ops.fused_exchange_stream.launches} "
                             f"exchange_stream launches, bodies "
                             f"{stream_paths}, expected 1 row")
    launches["exchange_stream"] += ops.fused_exchange_stream.launches
    reset_snn_counts()
    t0 = time.perf_counter()
    loop = run_loop()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    if ops.fused_exchange.launches != STEPS:
        raise AssertionError(f"route_step loop: {ops.fused_exchange.launches}"
                             f" exchange launches, expected {STEPS}")
    loop_paths = dict(ops.fused_exchange.launches_by_path)
    if loop_paths["row"] != STEPS:
        raise AssertionError(f"route_step loop: bodies {loop_paths}, "
                             f"expected {STEPS} row")
    launches["exchange"] += ops.fused_exchange.launches
    for name, a, b in (
            ("labels", out_l, torch.stack([f.labels for f, _ in loop])),
            ("valid", out_v, torch.stack([f.valid for f, _ in loop])),
            ("dropped", dropped, torch.stack([d for _, d in loop]))):
        parity.assert_equal(f"stream vs route_step loop {name}", b, a)
    if any(bool(f.times.any()) for f, _ in loop):
        raise AssertionError("route_step: untimed ingress carries times")
    print(f"phase 7: FULL_BACKPLANE stream: {STEPS} steps of {cfg.n_chips} x "
          f"{cap_in} egress frames ({int(frames.valid.sum())} events, "
          f"occupancy {OCC}) -> {int(out_v.sum())} delivered, "
          f"{int(dropped.sum())} dropped; one fused_exchange_stream launch "
          f"(bodies {stream_paths}) "
          f"{stream_s / STEPS * 1e6:.1f} us/step, {STEPS} route_step calls "
          f"{loop_s / STEPS * 1e6:.1f} us/step (exchange launches by body "
          f"{loop_paths}); equal bit for bit [{gpu}]",
          flush=True)

    # The Node-FPGA egress stage on a phase-3-sized run's rasters.
    name = "PROJECTED_120CHIP"
    cfg, params, plan = scenarios.engine_network(name, device=DEV)
    state = netlib.init_state(cfg, BATCH, device=DEV)
    drives = (torch.rand((STEPS, cfg.n_chips, BATCH, cfg.chip.n_rows),
                         generator=torch.Generator(device=DEV).manual_seed(3),
                         device=DEV) < DRIVE_P).to(torch.float32)
    out = stream.run_stream(params, state, drives, cfg, fabric=plan,
                            timed=True, device=DEV)
    grid = stream.egress_label_grid(cfg, DEV)
    table = params.router.fwd_tables[0]
    rasters = [out.spikes[t].transpose(0, 1) > 0.5 for t in range(STEPS)]

    def egress_loop(copy: bool):
        # copy: the caller makes the labels and flags contiguous first, as
        # the wrapper did before it read such views in place.
        return [ops.route_and_pack(
            *((x.contiguous() if copy else x)
              for x in (grid.expand(r.shape), r)),
            table, capacity=EGRESS_CAP) for r in rasters]

    egress_loop(False), egress_loop(True)                   # warm-up
    torch.cuda.synchronize()
    reset_counts(ops.route_and_pack)
    t0 = time.perf_counter()
    egress = egress_loop(False)
    torch.cuda.synchronize()
    egress_s = time.perf_counter() - t0
    egress_paths = dict(ops.route_and_pack.launches_by_path)
    if ops.route_and_pack.launches != STEPS or egress_paths["row"] != STEPS:
        raise AssertionError(f"egress: {ops.route_and_pack.launches} "
                             f"spike_router launches, bodies {egress_paths}, "
                             f"expected {STEPS} row")
    launches["spike_router"] += ops.route_and_pack.launches
    t0 = time.perf_counter()
    copied = egress_loop(True)
    torch.cuda.synchronize()
    copied_s = time.perf_counter() - t0
    for field, a, b in zip(("labels", "valid", "dropped"),
                           (torch.stack(x) for x in zip(*egress)),
                           (torch.stack(x) for x in zip(*copied))):
        parity.assert_equal(f"egress in place vs copied {field}", a, b)
    events = kept = dropped = 0
    for t, (r, got) in enumerate(zip(rasters, egress)):
        want = ref.spike_router_ref(grid.expand(r.shape), r, table,
                                    capacity=EGRESS_CAP)
        for field, a, b in zip(("labels", "valid", "dropped"), want, got):
            parity.assert_equal(f"egress step {t} {field}", a, b)
        events += int(r.sum())
        kept += int(got[1].sum())
        dropped += int(got[2].sum())
    if not kept:
        raise AssertionError("egress: no events kept")
    print(f"phase 7: {name} egress stage: {STEPS} steps of {BATCH} x "
          f"{cfg.n_chips} x {cfg.chip.n_neurons} spike rasters "
          f"({events} spikes, occupancy {events / out.spikes.numel():.4f}) "
          f"-> cap_in {EGRESS_CAP}: {kept} kept, {dropped} dropped, "
          f"{events - kept - dropped} disabled (chips >= 64 under the "
          f"identity LUT); bodies {egress_paths}; {egress_s / STEPS * 1e6:.1f}"
          f" us/step as called, labels and flags read in place "
          f"({copied_s / STEPS * 1e6:.1f} us/step with the caller's "
          f"contiguous copies); equal to the plain version bit for bit "
          f"[{gpu}]", flush=True)


# ---------------------------------------------------------------------------
# Phase 8: the LIF path
# ---------------------------------------------------------------------------


def phase8(launches: dict, gpu: str) -> None:
    shape = (LIF_BATCH * LIF_CHIPS, 512)
    gen = torch.Generator(device=DEV).manual_seed(14)
    v = torch.zeros(shape, device=DEV)
    i = torch.zeros(shape, device=DEV)
    drives = [0.6 * torch.rand(shape, generator=gen, device=DEV)
              for _ in range(STEPS)]
    lif_ops.lif_step.launches = 0
    err, flips, spikes = 0.0, 0, 0
    t0 = time.perf_counter()
    for t, d in enumerate(drives):
        # Teacher forcing: both sides start from the plain trajectory.
        e, f, (v, i, s) = lif_check(f"step {t}", v, i, d)
        err, flips, spikes = max(err, e), flips + f, spikes + int(s.sum())
    wall = time.perf_counter() - t0
    if lif_ops.lif_step.launches != STEPS:
        raise AssertionError(f"LIF path: {lif_ops.lif_step.launches} "
                             f"lif_step launches, expected {STEPS}")
    launches["lif_step"] += lif_ops.lif_step.launches
    if not spikes:
        raise AssertionError("LIF path: no spikes")
    print(f"phase 8: lif_step, {STEPS} steps at {LIF_BATCH} x {LIF_CHIPS} "
          f"chips x 512 neurons, teacher-forced: max abs err {err:.3g} "
          f"(tolerance {LIF_TOL}), {flips} near-threshold spike flips, "
          f"{spikes} spikes (rate {spikes / (STEPS * v.numel()):.4f}); "
          f"{wall:.2f} s with the checks [{gpu}]", flush=True)


# ---------------------------------------------------------------------------
# Phase 9: the degraded-mode stream
# ---------------------------------------------------------------------------


def edge_leaves(plan, level: int, edge: int) -> slice:
    """The leaves under an edge of ``level``."""
    gsize = plan.n_nodes // plan.edge_counts[level]
    return slice(edge * gsize, (edge + 1) * gsize)


def expected_fault_traffic(plan, faults, fault_mode, spikes):
    """Per step, from the healthy run's spikes ``[T, n_chips, batch,
    n_neurons]``: whether events are lost (a dead edge with no surviving
    route carries traffic: spikes under a dead uplink, spikes outside a dead
    downlink's subtree, as every chip sends to every other here) and
    whether events are detoured (a dead uplink with a live detour in the
    step's reroute plan carries traffic).  Returns two bool lists."""
    per_chip = spikes.sum(dim=(2, 3)).cpu()               # [T, n_chips]
    plans, _ = stream.fault_segments(plan, faults, fault_mode,
                                     spikes.shape[0], "cpu")
    lost, detoured = [], []
    for t, plan_t in enumerate(plans):
        lose = detour = False
        for level, edge, kind in fablib.dead_edges_at(faults, t):
            under = per_chip[t, edge_leaves(plan, level, edge)].sum()
            if kind == "downlink":
                lose |= bool(per_chip[t].sum() > under)
                continue
            live = (fault_mode == "reroute"
                    and plan_t.levels[level].detour[edge] >= 0)
            detour |= live and bool(under > 0)
            lose |= not live and bool(under > 0)
        lost.append(lose)
        detoured.append(detour)
    return lost, detoured


def phase9(launches: dict, gpu: str, healthy: dict) -> None:
    for name, mode, timed, fault_mode, faults, want in FAULT_PATHS:
        cfg, params, plan = scenarios.engine_network(name, device=DEV)
        plan = fablib.with_exchange_mode(plan, mode)
        state = netlib.init_state(cfg, BATCH, device=DEV)
        drives = main_drives(cfg)

        def run(d=drives, f=faults):
            return stream.run_stream(params, state, d, cfg, fabric=plan,
                                     timed=timed, faults=f,
                                     fault_mode=fault_mode, device=DEV)

        run(), run(f=None)                                  # warm-up
        # The healthy run of the same inputs in turns with the faulted one.
        outs, rates = in_turns(
            {"healthy": lambda: run(f=None), "faulted": run},
            launches, {"healthy": main_bodies(plan, mode, timed),
                       "faulted": want})
        out = outs["faulted"]
        what = f"{name}/{mode}/{'timed' if timed else 'untimed'}/{fault_mode}"
        healthy_rate, healthy_spikes = healthy[(name, mode, timed)]
        want_lost, want_detoured = expected_fault_traffic(
            plan, faults, fault_mode, healthy_spikes)
        lost = out.unroutable.sum(dim=(1, 2)).tolist()
        detoured = out.rerouted.sum(dim=(1, 2)).tolist()
        for t in range(STEPS):
            for field, n, expect in (("lost", lost[t], want_lost[t]),
                                     ("rerouted", detoured[t],
                                      want_detoured[t])):
                if (n > 0) != expect:
                    raise AssertionError(
                        f"{what}: step {t} {field} {n} events, expected "
                        f"{'some' if expect else 'none'}")
        # The run equals the healthy one through the first step that loses
        # events: until then the same events arrive (a detour delivers
        # them unchanged).
        first_loss = want_lost.index(True)
        parity.assert_equal(f"{what} spikes through step {first_loss}",
                            healthy_spikes[:first_loss + 1],
                            out.spikes[:first_loss + 1])
        window = [t for t in range(STEPS) if fablib.dead_edges_at(faults, t)]
        print(f"phase 9: {what}: faults "
              f"{[dataclasses.astuple(f) for f in faults]}; {STEPS} steps at "
              f"{rates['faulted'][0]:.1f} / {rates['faulted'][1]:.1f} "
              f"steps/s (the healthy run in turns: "
              f"{rates['healthy'][0]:.1f} / {rates['healthy'][1]:.1f}; "
              f"phase 3's: {healthy_rate:.1f}), lost "
              f"{sum(lost)} events in steps {window[0]}-{window[-1]} (none "
              f"outside), rerouted {sum(detoured)}, spikes equal to the "
              f"healthy run's through step {first_loss}; launches by body "
              f"{want} [{gpu}]", flush=True)
        local = fablib.shift_faults(faults, 16, PROFILE_STEPS)
        print(f"phase 9: {what}: " + device_breakdown(
            lambda: run(drives[16:16 + PROFILE_STEPS], local)) + f" [{gpu}]",
            flush=True)
    for fault_mode in ("mask", "reroute"):
        print("phase 9: " + card_vs_cpu("EXT_4CASE_96CHIP", "gather", True,
                                        CHECK_FAULTS, fault_mode), flush=True)


# ---------------------------------------------------------------------------
# Phase 10: the rest of run_stream's event path
# ---------------------------------------------------------------------------

# Overlap needs delay_steps >= 2: 0.25 us steps give 4 against the 950 ns
# chip-to-chip latency (the catalogue's 1 us steps give 1).
OVERLAP_DT_US = 0.25


def hierarchical_flag(plan, device) -> dict:
    """``run_stream``'s topology-flag arguments that compile the 2-level
    ``plan`` of the catalogue: all-to-all enables (no self-loop inside a
    backplane) and its two level capacities."""
    (per_pod, link), (n_pods, pod) = ((lvl.fan_in, lvl.link_capacity)
                                      for lvl in plan.levels)
    return dict(topology="hierarchical", n_pods=n_pods,
                intra_enables=routing.full_route_enables(per_pod,
                                                         device=device),
                inter_enables=torch.ones((n_pods, n_pods), dtype=torch.bool,
                                         device=device),
                link_capacity=link, pod_capacity=pod)


def phase10(launches: dict, gpu: str, healthy: dict) -> None:
    # (a) The hierarchical flag compiles PROJECTED_120CHIP's plan.
    name = "PROJECTED_120CHIP"
    cfg, params, plan = scenarios.engine_network(name, device=DEV)
    state = netlib.init_state(cfg, BATCH, device=DEV)
    drives = main_drives(cfg)
    flag = hierarchical_flag(plan, DEV)
    outs, rates = in_turns(
        {"flag": lambda: stream.run_stream(params, state, drives, cfg,
                                           timed=True, device=DEV, **flag),
         "fabric": lambda: stream.run_stream(params, state, drives, cfg,
                                             fabric=plan, timed=True,
                                             device=DEV)},
        launches, {"flag": {"merge_pack warp": STEPS},
                   "fabric": {"merge_pack warp": STEPS}})
    assert_same_stream("hierarchical flag against fabric=", outs["fabric"],
                       outs["flag"])
    parity.assert_equal("hierarchical flag against phase 3 spikes",
                        healthy[(name, "gather", True)][1],
                        outs["flag"].spikes)
    print(f"phase 10: {name}/timed through topology=\"hierarchical\" "
          f"(n_pods {flag['n_pods']}, link_capacity "
          f"{flag['link_capacity']}, pod_capacity {flag['pod_capacity']}): "
          f"equal bit for bit to the fabric= run and to phase 3's spikes; "
          f"{STEPS} merge_pack warp launches; steps/s flag "
          f"{rates['flag'][0]:.1f} / {rates['flag'][1]:.1f}, fabric= "
          f"{rates['fabric'][0]:.1f} / {rates['fabric'][1]:.1f} [{gpu}]",
          flush=True)

    # (b) overlap against the plain loop, at a 4-deep delay line.
    for name, timed, want in (
            ("FULL_BACKPLANE", False, {"exchange row": STEPS}),
            ("EXT_4CASE_96CHIP", True, {"merge_pack warp": STEPS})):
        cfg, params, plan = scenarios.engine_network(name, device=DEV)
        cfg = dataclasses.replace(cfg, dt_us=OVERLAP_DT_US)
        state = netlib.init_state(cfg, BATCH, device=DEV)
        drives = main_drives(cfg)

        def run(overlap, p=params, s=state, d=drives, c=cfg, pl=plan,
                tm=timed):
            return stream.run_stream(p, s, d, c, fabric=pl, timed=tm,
                                     overlap=overlap, device=DEV)

        outs, rates = in_turns(
            {"plain": lambda: run(False), "overlap": lambda: run(True)},
            launches, {"plain": want, "overlap": want}, rounds=3)
        what = f"{name}/{'timed' if timed else 'untimed'}"
        assert_same_stream(f"{what} overlap against plain", outs["plain"],
                           outs["overlap"])
        spikes = int(outs["plain"].spikes.sum())
        print(f"phase 10: {what} overlap=True (delay {cfg.delay_steps}): "
              f"equal bit for bit to overlap=False ({spikes} spikes); "
              f"launches {want} each; steps/s "
              f"in turns (plain, overlap, overlap, plain) x 3: plain "
              f"{', '.join(f'{r:.1f}' for r in rates['plain'])}; overlap "
              f"{', '.join(f'{r:.1f}' for r in rates['overlap'])} [{gpu}]",
              flush=True)
        for overlap in (False, True):
            def few(o=overlap, p=params, s=state, d=drives, c=cfg, pl=plan,
                    tm=timed):
                return stream.run_stream(p, s, d[:PROFILE_STEPS], c,
                                         fabric=pl, timed=tm, overlap=o,
                                         device=DEV)

            syncs = host_syncs(few)
            print(f"phase 10: {what} overlap={overlap}: {syncs} host "
                  f"synchronisations in {PROFILE_STEPS} steps; "
                  + device_breakdown(few) + f" [{gpu}]", flush=True)

    # (c) The merge engine against the exchange kernel, teacher-forced on
    # phase 3's FULL_BACKPLANE spikes.
    name = "FULL_BACKPLANE"
    cfg, params, plan = scenarios.engine_network(name, device=DEV)
    valid = healthy[(name, "gather", False)][1].transpose(1, 2) > 0.5
    labels = stream.egress_label_grid(cfg, DEV).expand(valid.shape)
    frames, _ = make_frame(labels, None, valid, cfg.capacity)

    def rounds(engine, n=STEPS, fr=frames, p=params, pl=plan):
        return [leaves(fablib.fabric_route_step(
            p.router, type(fr)(*(x[t] for x in fr)), pl, engine=engine))
            for t in range(n)]

    outs, rates = in_turns(
        {"auto": lambda: rounds("auto"), "merge": lambda: rounds("merge")},
        launches, {"auto": {"exchange row": STEPS},
                   "merge": {"merge_pack block": STEPS}})
    for t, (a, b) in enumerate(zip(outs["auto"], outs["merge"])):
        for f, x, y in zip(("labels", "times", "valid",
                            *fablib.ExchangeDrops._fields), a, b,
                           strict=True):
            parity.assert_equal(f"round {t} engine merge vs auto {f}", x, y)
    print(f"phase 10: {name} {STEPS} teacher-forced rounds ({BATCH} x "
          f"{cfg.n_chips} x {cfg.capacity} egress, "
          f"{int(frames.valid.sum())} events): engine=\"merge\" equal bit "
          f"for bit to \"auto\"; us/round auto "
          f"{1e6 / rates['auto'][0]:.1f} / {1e6 / rates['auto'][1]:.1f} "
          f"(exchange row {STEPS}), merge {1e6 / rates['merge'][0]:.1f} / "
          f"{1e6 / rates['merge'][1]:.1f} (merge_pack block {STEPS}) "
          f"[{gpu}]", flush=True)
    for engine in ("auto", "merge"):
        print(f"phase 10: {name} engine=\"{engine}\": " + device_breakdown(
            lambda e=engine: rounds(e, PROFILE_STEPS), unit="round")
            + f" [{gpu}]", flush=True)

    # (d) use_fused=False (the plain composition, no kernel) against the
    # fused run.
    name = "EXT_4CASE_96CHIP"
    cfg, params, plan = scenarios.engine_network(name, device=DEV)
    state = netlib.init_state(cfg, BATCH, device=DEV)
    drives = main_drives(cfg)

    def run(fused, p=params, s=state, d=drives, c=cfg, pl=plan):
        return stream.run_stream(p, s, d, c, fabric=pl, timed=True,
                                 use_fused=fused, device=DEV)

    outs, rates = in_turns(
        {"fused": lambda: run(True), "unfused": lambda: run(False)},
        launches, {"fused": {"merge_pack warp": STEPS}, "unfused": {}})
    assert_same_stream(f"{name} use_fused=False against fused",
                       outs["fused"], outs["unfused"])
    print(f"phase 10: {name}/timed use_fused=False: equal bit for bit to "
          f"the fused run, no kernel launched; steps/s fused "
          f"{rates['fused'][0]:.1f} / {rates['fused'][1]:.1f}, unfused "
          f"{rates['unfused'][0]:.1f} / {rates['unfused'][1]:.1f} [{gpu}]",
          flush=True)

    # (e) pick_exchange_mode over 64 rounds of phase 3's EXT_4CASE_96CHIP
    # timed spikes.
    valid = healthy[(name, "gather", True)][1].transpose(1, 2) > 0.5
    labels = stream.egress_label_grid(cfg, DEV).expand(valid.shape)
    frames, _ = make_frame(labels, torch.zeros_like(labels), valid,
                           cfg.capacity)
    trials = 3
    (picked, seconds), _, paths = counted(lambda: fablib.pick_exchange_mode(
        params.router, frames, plan, timing=timed_wire(cfg.latency),
        trials=trials))
    expect_bodies("pick_exchange_mode", paths,
                  {"merge_pack warp": 2 * (1 + trials) * STEPS}, launches)
    winner = min(seconds, key=seconds.get)
    if picked != fablib.with_exchange_mode(plan, winner) or not all(
            0 < v < float("inf") for v in seconds.values()):
        raise AssertionError(f"pick_exchange_mode: {picked.exchange_mode} "
                             f"from {seconds}")
    print(f"phase 10: {name}/timed pick_exchange_mode over {STEPS} rounds "
          f"(best of {trials}, interleaved): "
          + ", ".join(f"{m} {v * 1e3:.2f} ms ({v / STEPS * 1e6:.1f} "
                      f"us/round)" for m, v in seconds.items())
          + f"; winner {winner} [{gpu}]", flush=True)

    # (f) The per-step loop against the streamed run on the star.
    name = "FULL_BACKPLANE"
    cfg, params, plan = scenarios.engine_network(name, device=DEV)
    state = netlib.init_state(cfg, BATCH, device=DEV)
    drives = main_drives(cfg)
    outs, rates = in_turns(
        {"run_event": lambda: netlib.run_event(params, state, drives, cfg,
                                               device=DEV),
         "run_event_steps": lambda: netlib.run_event_steps(
             params, state, drives, cfg, device=DEV)},
        launches, {"run_event": {"exchange row": STEPS},
                   "run_event_steps": {"exchange row": STEPS}})
    for x, y in zip(leaves(outs["run_event"]), leaves(outs["run_event_steps"]),
                    strict=True):
        parity.assert_equal("run_event_steps against run_event", x, y)
    print(f"phase 10: {name} run_event_steps ({STEPS} step_event calls) "
          f"equal bit for bit to run_event; us/step run_event "
          f"{1e6 / rates['run_event'][0]:.0f} / "
          f"{1e6 / rates['run_event'][1]:.0f}, run_event_steps "
          f"{1e6 / rates['run_event_steps'][0]:.0f} / "
          f"{1e6 / rates['run_event_steps'][1]:.0f} [{gpu}]", flush=True)

    # (g) The card against the CPU on an overlap + hierarchical-flag run.
    print("phase 10: " + card_vs_cpu("PROJECTED_120CHIP", "gather", True,
                                     dt_us=OVERLAP_DT_US, flag=True,
                                     overlap=True), flush=True)

# ---------------------------------------------------------------------------
# Phase 11: the Fig 5 latency model
# ---------------------------------------------------------------------------

# benchmarks/fig5_latency.py's rate ladder (per sender, 3:1 fan-in) and the
# paper's sample count.
FIG5_RATES_HZ = (1e6, 5e6, 10e6, 25e6, 50e6, 70e6, 80e6, 83.3e6)
FIG5_SPIKES = 2 ** 15


def phase11(gpu: str) -> None:
    ms = {"card": [], "host": []}
    chip_meds, worst = [], None
    for level in ("fpga", "chip"):
        for rate in FIG5_RATES_HZ:
            gen = torch.Generator(device=DEV).manual_seed(int(rate))
            draws = latency.fan_in_draws(rate, FIG5_SPIKES, gen, 3, level)
            sides = (("card", DEV, draws),
                     ("host", torch.device("cpu"),
                      latency.FanInDraws(*(x.cpu() for x in draws))))
            lats = {}
            for side, dev, d in sides:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lats[side] = latency.simulate_fan_in(
                    rate, FIG5_SPIKES, fan_in=3, level=level, draws=d,
                    device=dev)
                torch.cuda.synchronize()
                ms[side].append((time.perf_counter() - t0) * 1e3)
            what = f"fan-in 3 x {rate / 1e6:g} MHz, {level} level"
            parity.assert_equal(f"{what}: card against CPU", lats["host"],
                                lats["card"])
            out = lats["card"]
            if out.shape != (FIG5_SPIKES,) or not bool(
                    (torch.remainder(out, latency.SYSTEM_CLOCK_NS) == 0)
                    .all()):
                raise AssertionError(f"{what}: not {FIG5_SPIKES} multiples "
                                     f"of {latency.SYSTEM_CLOCK_NS} ns")
            stats = latency.latency_statistics(out)
            if level == "chip":
                lo, hi = latency.PAPER_BAND_NS
                if not lo <= stats["median_ns"] <= hi:
                    raise AssertionError(f"{what}: median "
                                         f"{stats['median_ns']} ns outside "
                                         f"{latency.PAPER_BAND_NS}")
                chip_meds.append(stats["median_ns"])
                worst = stats
            print(f"phase 11: {what}, {FIG5_SPIKES} spikes: median "
                  f"{stats['median_ns']:.0f} ns, p01 {stats['p01_ns']:.0f}, "
                  f"p99 {stats['p99_ns']:.0f}, jitter "
                  f"{stats['jitter_frac'] * 100:.1f}% of the median; card "
                  f"== CPU bit for bit; {ms['card'][-1]:.1f} ms a call on "
                  f"the card, {ms['host'][-1]:.1f} ms on the host [{gpu}]",
                  flush=True)
    # The reference battery's Fig 5 properties (tests/test_latency_model.py).
    for a, b in zip(chip_meds, chip_meds[1:]):
        if b < a - latency.SYSTEM_CLOCK_NS:
            raise AssertionError(f"chip medians not monotone: {chip_meds}")
    frac = latency.PAPER_JITTER_FRAC
    if not 0.66 * frac <= worst["jitter_frac"] <= 1.66 * frac:
        raise AssertionError(f"worst-regime jitter {worst['jitter_frac']} "
                             f"not near {frac}")
    ranks = torch.arange(5 * latency.DEFAULT_PARAMS.cc_interval, device=DEV)
    total = latency.hop_delays(latency.DEFAULT_PARAMS, ranks).total_ns
    lane = latency.queue_wait_i32(ranks, timed_wire().queue)
    parity.assert_equal("hop_delays total against queue_wait_i32",
                        lane.to(torch.float32), total)
    print(f"phase 11: chip-level medians {chip_meds} ns: inside "
          f"{latency.PAPER_BAND_NS}, monotone within one 8 ns tick; "
          f"83.3 MHz jitter {worst['jitter_frac']:.3f} of the median "
          f"(paper {frac}); hop_delays(...).total_ns == queue_wait_i32 on "
          f"ranks 0-{len(ranks) - 1} on the card; ms a call, median of "
          f"{len(ms['card'])}: card {float(np.median(ms['card'])):.1f}, "
          f"host {float(np.median(ms['host'])):.1f} (first card call "
          f"{ms['card'][0]:.1f}) [{gpu}]", flush=True)


# ---------------------------------------------------------------------------
# Phase 12: online plasticity and slot masking
# ---------------------------------------------------------------------------


def idle_mask(steps: int, start: int, stop: int) -> torch.Tensor:
    """bool[steps, BATCH]: slots BATCH/2 and up idle over [start, stop)."""
    mask = torch.ones((steps, BATCH), dtype=torch.bool)
    mask[start:stop, BATCH // 2:] = False
    return mask


# Slots 4-7 idle over steps 16-47 of STEPS (the multi-tenant engine's idle
# sessions), and over steps 4-11 of CHECK_STEPS for the card-against-CPU
# check.
IDLE_STEPS = (16, 48)
SLOT_MASK = idle_mask(STEPS, *IDLE_STEPS)
CHECK_MASK = idle_mask(CHECK_STEPS, 4, 12)
STDP = plas.STDPConfig()


def assert_same_plastic(what: str, a, b) -> None:
    """Two plastic runs equal bit for bit, plasticity state included."""
    assert_same_stream(what, a, b)
    for x, y in zip(a.plasticity, b.plasticity, strict=True):
        parity.assert_equal(f"{what} plasticity", x, y)


def chained(run, drives, mask, ps, cuts) -> list:
    """``run`` over the windows between ``cuts``, each from the last
    one's state and plasticity state."""
    outs, state = [], None
    for a, b in zip(cuts, cuts[1:]):
        out = run(drives[a:b], state=state, ps=ps,
                  mask=None if mask is None else mask[a:b])
        outs.append(out)
        state, ps = out.state, out.plasticity
    return outs


def joined(outs):
    """The chained windows as one run's outputs."""
    return outs[-1]._replace(**{f: torch.cat([getattr(o, f) for o in outs])
                             for f in STREAM_FIELDS})


def phase12(launches: dict, gpu: str) -> None:
    # (a) Shared plasticity against the plain run, in turns.
    for name, mode, timed in (("EXT_4CASE_96CHIP", "gather", True),
                              ("FULL_BACKPLANE", "gather", False)):
        cfg, params, plan = scenarios.engine_network(name, device=DEV)
        plan = fablib.with_exchange_mode(plan, mode)
        state0 = netlib.init_state(cfg, BATCH, device=DEV)
        drives = main_drives(cfg)
        want = main_bodies(plan, mode, timed)

        def run(d=drives, state=None, ps=None, mask=None, plastic=True,
                p=params, c=cfg, pl=plan, tm=timed, s0=state0):
            kw = (dict(plasticity=STDP, plasticity_state=ps, slot_mask=mask)
                  if plastic else {})
            return stream.run_stream(p, s0 if state is None else state, d, c,
                                     fabric=pl, timed=tm, device=DEV, **kw)

        run(drives[:4])                                     # warm-up
        outs, rates = in_turns({"plain": lambda: run(plastic=False),
                                "plastic": run}, launches,
                               {"plain": want, "plastic": want}, rounds=3)
        out = outs["plastic"]
        moved = out.plasticity.weights != params.chips.weights
        if not bool(moved.any()):
            raise AssertionError(f"{name}: the weights did not move")
        assert_same_plastic(f"{name} two chained windows against one run",
                            out, joined(chained(run, drives, None, None,
                                                (0, STEPS // 2, STEPS))))
        what = f"{name}/{'timed' if timed else 'untimed'}"
        print(f"phase 12: {what} shared plasticity: "
              f"{float(moved.float().mean()):.3f} of the weights moved "
              f"(max {float((out.plasticity.weights - params.chips.weights).abs().max()):.2f}), "
              f"{int(out.spikes.sum())} spikes against "
              f"{int(outs['plain'].spikes.sum())} plain; two chained "
              f"{STEPS // 2}-step windows equal the {STEPS}-step run bit for "
              f"bit; launches by body {want} in every run, as phase 3's; "
              f"steps/s in turns (plain, plastic, plastic, plain) x 3: plain "
              f"{', '.join(f'{r:.1f}' for r in rates['plain'])}; plastic "
              f"{', '.join(f'{r:.1f}' for r in rates['plastic'])} [{gpu}]",
              flush=True)
        print(f"phase 12: {what} shared plasticity: " + device_breakdown(
            lambda: run(drives[:PROFILE_STEPS])) + f" [{gpu}]", flush=True)

    # (b) Per-slot plasticity with slots 4-7 idle over steps 16-47.
    name = "EXT_4CASE_96CHIP"
    cfg, params, plan = scenarios.engine_network(name, device=DEV)
    state0 = netlib.init_state(cfg, BATCH, device=DEV)
    drives = main_drives(cfg)
    mask = SLOT_MASK.to(DEV)
    want = {"merge_pack warp": STEPS}

    def slot_run(d=drives, state=None, ps=None, mask=mask, batch=BATCH,
                 plastic=True, **kw):
        if plastic:
            kw.update(plasticity=STDP, slot_mask=mask, plasticity_state=(
                netlib.init_slot_plasticity(params, batch) if ps is None
                else ps))
        return stream.run_stream(
            params, netlib.init_state(cfg, batch, device=DEV)
            if state is None else state, d, cfg, fabric=plan, timed=True,
            device=DEV, **kw)

    slot_run(drives[:4], mask=mask[:4])                     # warm-up
    torch.cuda.reset_peak_memory_stats(DEV)
    before = stdp_ops.stdp_slot.launches
    outs, rates = in_turns({"plain": lambda: slot_run(plastic=False),
                            "per-slot": slot_run}, launches,
                           {"plain": want, "per-slot": want}, rounds=3)
    peak = torch.cuda.max_memory_allocated(DEV)
    stdp_launches = stdp_ops.stdp_slot.launches - before
    if stdp_launches != 6 * STEPS:
        raise AssertionError(f"per-slot: {stdp_launches} stdp_slot launches "
                             f"in 6 runs of {STEPS} steps, expected one a "
                             f"step")
    out = outs["per-slot"]
    start, stop = IDLE_STEPS
    idle = (slice(start, stop), slice(None), slice(BATCH // 2, None))
    if float(out.spikes[idle].sum()) or int(out.dropped[idle].sum()):
        raise AssertionError("per-slot: idle slots emitted events")
    windows = chained(slot_run, drives, mask, None, (0, start, stop, STEPS))
    assert_same_plastic("per-slot: three chained windows against one run",
                        out, joined(windows))
    for field, before, after in zip(plas.SlotPlasticityState._fields,
                                    windows[0].plasticity,
                                    windows[1].plasticity):
        parity.assert_equal(f"per-slot: idle slots' {field} over steps "
                            f"{start}-{stop - 1}", before[:, BATCH // 2:],
                            after[:, BATCH // 2:])
        if torch.equal(before[:, :BATCH // 2], after[:, :BATCH // 2]):
            raise AssertionError(f"per-slot: the busy slots' {field} did "
                                 f"not move over steps {start}-{stop - 1}")
    # Each row equals a batch-1 run of its own, over CHECK_STEPS steps with
    # CHECK_MASK.
    short = CHECK_MASK.to(DEV)
    together = slot_run(drives[:CHECK_STEPS], mask=short)
    for b in range(BATCH):
        alone = slot_run(drives[:CHECK_STEPS, :, b:b + 1],
                         mask=short[:, b:b + 1], batch=1)
        for f in STREAM_FIELDS:
            parity.assert_equal(f"per-slot row {b} alone: {f}",
                                getattr(alone, f),
                                getattr(together, f)[:, :, b:b + 1])
        for x, y in zip(leaves(alone.state), leaves(together.state)):
            parity.assert_equal(f"per-slot row {b} alone: state", x,
                                y[..., b:b + 1, :])
        for x, y in zip(alone.plasticity, together.plasticity):
            parity.assert_equal(f"per-slot row {b} alone: plasticity", x,
                                y[:, b:b + 1])
    print(f"phase 12: {name}/timed per-slot plasticity, slots "
          f"{BATCH // 2}-{BATCH - 1} idle over steps {start}-{stop - 1}: "
          f"the idle slots emitted nothing there and their "
          f"traces and weights did not move; three chained windows equal "
          f"the {STEPS}-step run bit for bit; each of the {BATCH} rows "
          f"equals a batch-1 run over {CHECK_STEPS} steps bit for bit; "
          f"launches by body {want} in every run and one stdp_slot launch "
          f"a per-slot step; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB (per-slot weights "
          f"{out.plasticity.weights.numel() * 4 / 1e6:.0f} MB); steps/s in "
          f"turns (plain, per-slot, per-slot, plain) x 3: plain "
          f"{', '.join(f'{r:.1f}' for r in rates['plain'])}; per-slot "
          f"{', '.join(f'{r:.1f}' for r in rates['per-slot'])} [{gpu}]",
          flush=True)
    print(f"phase 12: {name}/timed per-slot plasticity: " + device_breakdown(
        lambda: slot_run(drives[:PROFILE_STEPS], mask=mask[:PROFILE_STEPS]))
        + f" [{gpu}]", flush=True)

    # (c) Overlap with the mask against the plain loop (per-slot).
    name = "FULL_BACKPLANE"
    cfg, params, plan = scenarios.engine_network(name, device=DEV)
    cfg = dataclasses.replace(cfg, dt_us=OVERLAP_DT_US)
    state0 = netlib.init_state(cfg, BATCH, device=DEV)
    drives = main_drives(cfg)

    def run(overlap):
        return stream.run_stream(
            params, state0, drives, cfg, fabric=plan, overlap=overlap,
            plasticity=STDP, slot_mask=mask,
            plasticity_state=netlib.init_slot_plasticity(params, BATCH),
            device=DEV)

    want = {"exchange row": STEPS}
    outs, _ = in_turns({"plain": lambda: run(False),
                        "overlap": lambda: run(True)}, launches,
                       {"plain": want, "overlap": want})
    assert_same_plastic(f"{name} overlap against plain", outs["plain"],
                        outs["overlap"])
    print(f"phase 12: {name}/untimed per-slot plasticity with the slot mask, "
          f"overlap=True (delay {cfg.delay_steps}): equal bit for bit to "
          f"overlap=False; launches by body {want} each [{gpu}]", flush=True)

    # (d) The card against the CPU on 16 plastic steps.
    for name, mode, timed, plastic in (
            ("EXT_4CASE_96CHIP", "gather", True, "shared"),
            ("FULL_BACKPLANE", "gather", False, "slot")):
        print("phase 12: " + card_vs_cpu(name, mode, timed, plastic=plastic),
              flush=True)


# ---------------------------------------------------------------------------
# Phase 13: the durable runtime and the multi-tenant engine
# ---------------------------------------------------------------------------

WINDOW = 8                        # steps per supervised window / engine step
CKPT_ROOT = pathlib.Path(__file__).resolve().parent / "build"
ENGINE_SLOTS, ENGINE_SESSIONS = 8, 24
ENGINE_LENGTHS = (16, 64)         # session lengths drawn from this range
ENGINE_RATE = 0.15                # stimulus spike probability per chip-0 row


def ckpt_mb(directory: str, step: int) -> float:
    return sum(e["bytes"] for e in
               ckpt.read_manifest(directory, step)["leaves"]) / 1e6


def median_s(fn, n: int = 3) -> float:
    """Median wall seconds of ``fn()`` over ``n`` calls, synchronised."""
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return sorted(walls)[n // 2]


def phase13_supervised(launches: dict, gpu: str, tmp: pathlib.Path) -> None:
    """(a) The supervised shared-plastic stream against one long run."""
    name = "EXT_4CASE_96CHIP"
    cfg, params, plan = scenarios.engine_network(name, device=DEV)
    state0 = netlib.init_state(cfg, BATCH, device=DEV)
    drives = main_drives(cfg)
    want = main_bodies(plan, "gather", True)
    kw = dict(fabric=plan, plasticity=STDP, device=DEV)
    dirs = itertools.count()

    def plain(d=drives):
        return stream.run_stream(params, state0, d, cfg, timed=True, **kw)

    def supervised(d=drives, sync=False, **extra):
        return elastic.run_supervised_stream(
            params, state0, d, cfg, window=WINDOW,
            ckpt_dir=str(tmp / f"sup{next(dirs)}"), keep=2,
            stream_kwargs={"timed": True}, async_checkpoint=not sync,
            **kw, **extra)

    plain(drives[:4])                                       # warm-up
    supervised(drives[:4])
    torch.cuda.reset_peak_memory_stats(DEV)
    outs, rates = in_turns({"plain": plain,
                            "supervised": lambda: supervised()[0]},
                           launches, {"plain": want, "supervised": want},
                           rounds=3)
    peak = torch.cuda.max_memory_allocated(DEV)
    long = outs["plain"]
    assert_same_plastic("supervised (async writer) against one run",
                        long, outs["supervised"])
    sync_outs, sync_rates = in_turns(
        {"plain": plain, "supervised sync": lambda: supervised(sync=True)[0]},
        launches, {"plain": want, "supervised sync": want})
    assert_same_plastic("supervised (sync) against one run", long,
                        sync_outs["supervised sync"])

    def per_boundary_ms(sup, base):
        return (STEPS / np.median(sup) - STEPS / np.median(base)) / (
            STEPS // WINDOW) * 1e3

    # One boundary's save, verify and restore, timed on their own.
    d = str(tmp / "boundary")
    fp = elastic.stream_fingerprint(cfg, fabric=plan, plasticity=STDP)
    steps = iter(range(0, 1000, WINDOW))
    save_s = median_s(lambda: elastic.save_stream_state(
        d, next(steps), long.state, plasticity=long.plasticity,
        fingerprint=fp))
    newest = ckpt.latest_step(d)
    verify_s = median_s(lambda: ckpt._verify_dir(
        str(pathlib.Path(d) / f"step_{newest:08d}")))
    plast_like = netlib.init_stream_plasticity(params, BATCH)
    restore_s = median_s(lambda: elastic.restore_stream_checkpoint(
        d, state0, step=newest, plasticity_like=plast_like,
        expect_fingerprint=fp, device=DEV))
    mb = ckpt_mb(d, newest)
    print(f"phase 13: {name}/timed supervised shared-plastic stream, batch "
          f"{BATCH} x {STEPS} steps, window {WINDOW}, a checkpoint every "
          f"window ({mb:.1f} MB each): equal bit for bit to one "
          f"{STEPS}-step run with the async writer and with sync saves; "
          f"launches by body {want} in every run, as phase 3's; steps/s in "
          f"turns (plain, supervised, supervised, plain) x 3: plain "
          f"{', '.join(f'{r:.1f}' for r in rates['plain'])}; supervised "
          f"{', '.join(f'{r:.1f}' for r in rates['supervised'])}; sync "
          f"saves in turns x 1: plain "
          f"{', '.join(f'{r:.1f}' for r in sync_rates['plain'])}; "
          f"supervised sync "
          f"{', '.join(f'{r:.1f}' for r in sync_rates['supervised sync'])}; "
          f"cost per boundary over plain (medians): async "
          f"{per_boundary_ms(rates['supervised'], rates['plain']):.1f} ms, "
          f"sync {per_boundary_ms(sync_rates['supervised sync'], sync_rates['plain']):.1f} ms; "
          f"one boundary alone: save {save_s * 1e3:.1f} ms (card to host, "
          f"sha256, fsync, rename), verify {verify_s * 1e3:.1f} ms, restore "
          f"{restore_s * 1e3:.1f} ms (sha256, host to card); peak device "
          f"memory {peak / 2 ** 30:.2f} GiB [{gpu}]", flush=True)
    print(f"phase 13: {name}/timed supervised shared-plastic stream: "
          + device_breakdown(lambda: supervised(drives[:2 * WINDOW]),
                             per=2 * WINDOW) + f" [{gpu}]", flush=True)

    # A kill at step 32's boundary (pre_rename), then a resume.
    d = str(tmp / "killed")
    half = STEPS // 2
    pre, _ = elastic.run_supervised_stream(
        params, state0, drives[:half], cfg, window=WINDOW, ckpt_dir=d,
        stream_kwargs={"timed": True}, async_checkpoint=False, **kw)
    ckpt.set_crash_point("pre_rename")
    try:
        elastic.save_stream_state(d, half, pre.state,
                                  plasticity=pre.plasticity, fingerprint=fp)
        raise AssertionError("the armed crash point did not fire")
    except ckpt.CrashInjected:
        pass
    finally:
        ckpt.set_crash_point(None)
    out, info = elastic.resume_supervised_stream(
        params, state0, drives, cfg, window=WINDOW, ckpt_dir=d,
        stream_kwargs={"timed": True}, **kw)
    s = info["resumed_step"]
    if s != half - WINDOW:
        raise AssertionError(f"resumed at {s}, expected {half - WINDOW}")
    assert_same_plastic(f"resumed at step {s} against the long run's tail",
                        long._replace(**{f: getattr(long, f)[s:]
                                         for f in STREAM_FIELDS}), out)

    # The watchdog fires on a stalled window and recovery continues on a
    # degraded plan: equal to a direct degraded run from the checkpoint.
    d = str(tmp / "recovered")
    degraded = fablib.compile_fabric(fablib.degrade_spec(plan.spec,
                                                         [(1, 0)]))
    wd = watchdog.StepWatchdog(watchdog.WatchdogConfig(
        deadline_factor=1.0, min_deadline_s=0.5, ema_alpha=1.0,
        refractory_s=5.0))
    stalled = 2

    def stall(widx):
        if widx == stalled:
            time.sleep(1.0)

    t0 = time.perf_counter()
    out, recs = elastic.run_supervised_stream(
        params, state0, drives, cfg, window=WINDOW, ckpt_dir=d, watchdog=wd,
        on_recover=lambda w, p: degraded, stall_probe=stall,
        stream_kwargs={"timed": True}, **kw)
    wall = time.perf_counter() - t0
    at = stalled * WINDOW
    if [(r["window"], r["restored_step"]) for r in recs] != [(stalled, at)]:
        raise AssertionError(f"recoveries {recs}")
    ck = elastic.restore_stream_checkpoint(d, state0, step=at,
                                           plasticity_like=plast_like,
                                           expect_fingerprint=fp, device=DEV)
    direct = stream.run_stream(params, ck.state, drives[at:], cfg, timed=True,
                               fabric=degraded, plasticity=STDP,
                               plasticity_state=ck.plasticity, device=DEV)
    for f in STREAM_FIELDS:
        parity.assert_equal(f"recovered {f} before step {at}",
                            getattr(long, f)[:at], getattr(out, f)[:at])
    assert_same_plastic("recovered against a direct degraded run",
                        direct, out._replace(**{f: getattr(out, f)[at:]
                                                for f in STREAM_FIELDS}))
    rerouted = int(out.rerouted[at:].sum())
    if not rerouted:
        raise AssertionError("the degraded plan rerouted nothing")
    print(f"phase 13: {name}/timed supervised: a pre_rename kill at step "
          f"{half} resumed from step {s}, the tail equal bit for bit to the "
          f"long run's; the watchdog (deadline max(0.5 s, last window)) "
          f"fired on window {stalled} (stalled 1 s), recovery from step "
          f"{at} onto {degraded.describe()!r} equal bit for bit to a direct "
          f"degraded run from that checkpoint ({rerouted} events "
          f"rerouted), {wall:.2f} s in all [{gpu}]", flush=True)


def engine_stims(cfg, n: int, lengths, rate: float, seed: int,
                 dyadic: bool = False) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        L = int(rng.integers(lengths[0], lengths[1] + 1))
        stim = (rng.random((L, cfg.chip.n_rows)) < rate).astype(np.float32)
        if dyadic:
            stim *= rng.integers(4, 20, stim.shape) / 16
        out.append(stim.astype(np.float32))
    return out


def batch_one(params, cfg, plan, stim, device):
    """A session's batch-1 ``run_stream`` (chip 0 driven, per-slot
    plasticity, timed)."""
    drives = torch.zeros((stim.shape[0], cfg.n_chips, 1, cfg.chip.n_rows),
                         device=device)
    drives[:, 0, 0] = torch.from_numpy(stim).to(device)
    return stream.run_stream(
        params, netlib.init_state(cfg, 1, device=device), drives, cfg,
        fabric=plan, timed=True, plasticity=STDP,
        plasticity_state=netlib.init_slot_plasticity(params, 1),
        device=device)


def same_session(what: str, r, out=None, other=None) -> None:
    """A ``SessionResult`` against a batch-1 ``StreamOut`` or another
    ``SessionResult``, bit for bit."""
    if out is not None:
        lat = stream.masked_latency_stats(out.latency_ns, out.latency_valid,
                                          strict=False)
        other = engine.SessionResult(
            session_id=r.session_id, steps=out.spikes.shape[0],
            spikes=out.spikes[:, :, 0].cpu().numpy(),
            spike_count=int(out.spikes.sum()), latency=lat,
            plasticity=type(out.plasticity)(
                *(x[:, 0].cpu().numpy() for x in out.plasticity)),
            submitted_at=0.0, finished_at=0.0,
            **{k: int(getattr(out, k).sum()) for k in
               ("dropped", "uplink_dropped", "unroutable", "rerouted")})
    for f in ("steps", "spike_count", "dropped", "uplink_dropped",
              "unroutable", "rerouted"):
        if getattr(r, f) != getattr(other, f):
            raise AssertionError(f"{what} {f}: {getattr(r, f)} != "
                                 f"{getattr(other, f)}")
    parity.assert_equal(f"{what} spikes", other.spikes, r.spikes)
    a, b = r.latency, other.latency
    if a["count"] != b["count"] or any(
            a[k] != b[k] for k in a if not (np.isnan(a[k]) and
                                            np.isnan(b[k]))):
        raise AssertionError(f"{what} latency {a} != {b}")
    for x, y in zip(r.plasticity, other.plasticity, strict=True):
        parity.assert_equal(f"{what} plasticity", y, x)


def phase13_engine(launches: dict, gpu: str, tmp: pathlib.Path) -> None:
    """(b) The engine at full chip width against batch-1 runs; (c) the
    engine on the card against the CPU."""
    name = "EXT_4CASE_96CHIP"
    cfg, params, plan = scenarios.engine_network(name, device=DEV)
    stims = engine_stims(cfg, ENGINE_SESSIONS, ENGINE_LENGTHS, ENGINE_RATE,
                         seed=13)
    eng = engine.EmulationEngine(params, cfg, slots=ENGINE_SLOTS,
                                 max_steps=ENGINE_LENGTHS[1], window=WINDOW,
                                 plan=plan, timed=True, plasticity=STDP,
                                 device=DEV)
    eng.warm()
    torch.cuda.reset_peak_memory_stats(DEV)
    sids = [eng.submit(s) for s in stims]
    windows = itertools.count(1)

    def drain():
        n = 0
        while eng.active or eng.queued:
            eng.step()
            n = next(windows)
        return n

    n_windows, wall, paths = counted(drain)
    peak = torch.cuda.max_memory_allocated(DEV)
    expect_bodies("engine", paths, {"merge_pack warp": WINDOW * n_windows},
                  launches)
    results = [eng.collect(sid) for sid in sids]
    seq_wall, spikes, events = 0.0, 0, 0
    for r, stim in zip(results, stims):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = batch_one(params, cfg, plan, stim, DEV)
        torch.cuda.synchronize()
        seq_wall += time.perf_counter() - t0
        same_session(f"session {r.session_id} against its batch-1 run", r,
                     out=out)
        spikes += r.spike_count
        events += r.latency["count"]
    if not spikes or not events:
        raise AssertionError(f"engine: {spikes} spikes, {events} events")
    steps = sum(s.shape[0] for s in stims)
    print(f"phase 13: {name}/timed engine, S={ENGINE_SLOTS} slots, "
          f"per-slot plasticity, window {WINDOW}: {ENGINE_SESSIONS} sessions "
          f"of {min(s.shape[0] for s in stims)}-"
          f"{max(s.shape[0] for s in stims)} steps ({steps} session-steps, "
          f"{spikes} spikes, {events} delivered events) in {n_windows} "
          f"windows, each session equal bit for bit to its batch-1 "
          f"run_stream (spikes, 4 drop fields, latency statistics, "
          f"plasticity row); launches by body {paths}; "
          f"{ENGINE_SESSIONS / wall:.2f} experiments/s batched "
          f"({wall:.2f} s) against {ENGINE_SESSIONS / seq_wall:.2f} "
          f"sequential batch-1 ({seq_wall:.2f} s): "
          f"{seq_wall / wall:.2f}x; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB [{gpu}]", flush=True)
    for s in stims[:ENGINE_SLOTS]:
        eng.submit(s)
    print(f"phase 13: {name}/timed engine: " + device_breakdown(
        lambda: [eng.step() for _ in range(2)], per=2 * WINDOW,
        unit="session-step") + f" [{gpu}]", flush=True)
    eng.drain()
    for sid in eng.done:
        eng.collect(sid)

    # Evict after two windows, restore into a busy engine, finish.
    first = eng.submit(stims[0])
    for s in stims[1:ENGINE_SLOTS]:
        eng.submit(s)
    eng.step()
    eng.step()
    d = str(tmp / "evicted")
    partial = eng.evict(first, d)
    resumed = eng.submit(stims[0], restore_from=d)
    eng.drain()
    rest = eng.collect(resumed)
    whole = results[0]
    parity.assert_equal("evicted and restored: stitched spikes",
                        whole.spikes,
                        np.concatenate([partial.spikes, rest.spikes]))
    for f in ("steps", "spike_count", "dropped", "uplink_dropped",
              "unroutable", "rerouted"):
        if getattr(partial, f) + getattr(rest, f) != getattr(whole, f):
            raise AssertionError(f"evicted and restored: {f}")
    if (partial.latency["count"] + rest.latency["count"]
            != whole.latency["count"]):
        raise AssertionError("evicted and restored: latency count")
    for x, y in zip(rest.plasticity, whole.plasticity, strict=True):
        parity.assert_equal("evicted and restored: plasticity", y, x)
    print(f"phase 13: {name}/timed engine: session 0 evicted after "
          f"{partial.steps} steps ({ckpt_mb(d, partial.steps):.1f} MB) and "
          f"restored into a busy engine: the stitched session equals the "
          f"uninterrupted one bit for bit [{gpu}]", flush=True)

    # The serving CLI, once, at full width.
    t0 = time.perf_counter()
    _, _, paths = counted(lambda: serve_emulation.main(
        ["--scenario", name, "--sessions", "12", "--slots", "4", "--timed",
         "--plastic", "--rate", str(ENGINE_RATE)]))
    if set(paths) != {"merge_pack warp"}:
        raise AssertionError(f"serve_emulation launched {paths}")
    launches["merge_pack"] += paths["merge_pack warp"]
    print(f"phase 13: serve_emulation.main() on the card in "
          f"{time.perf_counter() - t0:.1f} s, launches by body {paths} "
          f"[{gpu}]", flush=True)

    # (c) The card against the CPU on a short engine run: FULL_BACKPLANE,
    # dyadic weights and stimuli, 4 slots, windows of 4 steps.
    name = "FULL_BACKPLANE"
    results = {}
    t0 = time.perf_counter()
    for side, dev in (("cpu", torch.device("cpu")), ("card", DEV)):
        cfg, params, plan = scenarios.engine_network(name, device=dev)
        params = params._replace(chips=params.chips._replace(
            w_scale=torch.full_like(params.chips.w_scale, 2.0 ** -8)))
        stims = engine_stims(cfg, 6, (4, 8), 0.3, seed=14, dyadic=True)
        eng = engine.EmulationEngine(params, cfg, slots=4, max_steps=8,
                                     window=4, plan=plan, timed=True,
                                     plasticity=STDP, device=dev)
        sids = [eng.submit(s) for s in stims]
        eng.drain()
        results[side] = [eng.collect(sid) for sid in sids]
    for a, b in zip(results["cpu"], results["card"], strict=True):
        same_session(f"{name} session {a.session_id} card against CPU", b,
                     other=a)
    spikes = sum(r.spike_count for r in results["cpu"])
    if not spikes:
        raise AssertionError(f"{name} engine: no spikes to compare")
    print(f"phase 13: {name}/timed engine, S=4, per-slot plasticity, "
          f"window 4, {len(stims)} sessions of 4-8 steps: card == CPU "
          f"session for session bit for bit ({spikes} spikes), "
          f"{time.perf_counter() - t0:.1f} s [{gpu}]", flush=True)


def phase13(launches: dict, gpu: str) -> None:
    import tempfile

    CKPT_ROOT.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=CKPT_ROOT,
                                     prefix="phase13-") as tmp:
        phase13_supervised(launches, gpu, pathlib.Path(tmp))
        phase13_engine(launches, gpu, pathlib.Path(tmp))


# ---------------------------------------------------------------------------
# Phase 14: the sharded fabric executor on torch.distributed
# ---------------------------------------------------------------------------

SHARD_ROUNDS = 64
# Rounds through exchange_fn: all 64 on FULL_BACKPLANE; the first 16 on the
# 3-level twin and the legacy jobs, whose 64 rounds go through stream_fn
# (each exchange_fn round waits on gloo's per-message latency).
SHARD_LOOP_SHORT = 16
SHARD_STREAM_REPEATS = 3
SHARD_OCCS = (OCC, 0.5)
# EXT_4CASE_96CHIP's three levels at fan-in 2 each: 96 ranks do not fit one
# card, so the 3-level plan runs on 8 (as the reference's own 8-device tests
# shrink it), at EXT_4CASE_96CHIP's cap_in and ingress capacity.
EXT_TWIN = (2, 2, 2)
SHARD_FIELDS = ("labels", "times", "valid", "congestion", "uplink",
                "unroutable", "rerouted")


def shard_inputs(seed: int, n: int, cap_in: int, occ: float) -> dict:
    """SHARD_ROUNDS rounds of n egress frames (labels over 16 bits, each
    raw slot valid with ``occ``, departures in [0, 1000) ns) compacted by
    ``make_frame``, and random LUTs (about 15% of entries off), as host
    numpy for the ranks."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    shape = (SHARD_ROUNDS, n, cap_in)
    frame, _ = make_frame(
        torch.randint(0, 1 << 16, shape, generator=gen, device=DEV,
                      dtype=torch.int32),
        torch.randint(0, 1000, shape, generator=gen, device=DEV,
                      dtype=torch.int32),
        torch.rand(shape, generator=gen, device=DEV) < occ, cap_in)
    d = dict(zip(("labels", "times", "valid"), frame))
    d["fwd"] = lut(gen, n, 1 << 16, 15, 15)
    d["rev"] = lut(gen, n, 1 << 15, 16, 16)
    return {k: v.cpu().numpy() for k, v in d.items()}


def health_on(spec, plan, device):
    """A ``FabricHealth`` overlay from ``{(side, level): dead edges}``."""
    if spec is None:
        return None
    sides = {"uplink": [None] * plan.n_levels,
             "downlink": [None] * plan.n_levels}
    for (side, level), dead in spec.items():
        vec = torch.ones(plan.edge_counts[level], dtype=torch.bool)
        vec[list(dead)] = False
        sides[side][level] = vec.to(device)
    return fablib.FabricHealth(uplink=tuple(sides["uplink"]),
                               downlink=tuple(sides["downlink"]))


def wire_per_level(plan, cap_in: int, timed: bool) -> list[int]:
    """Bytes one rank receives per round at each level: f - 1 rows of the
    level's stream, 2 B a wire word and 4 B a timestamp (gather; routed
    on these plans' enables, which prune no pair, the same)."""
    return [(lvl.fan_in - 1) * (sum(seg) // lvl.fan_in) * (2 + 4 * timed)
            for lvl, seg in zip(plan.levels, plan.merge_layout(cap_in))]


def shard_wire() -> dict:
    return dict(gathers=fablib._gather_plane.calls,
                gather_bytes=fablib._gather_plane.bytes,
                sends=fablib._routed_plane.sends,
                p2p_bytes=fablib._routed_plane.bytes)


def reset_shard_wire() -> None:
    fablib._gather_plane.calls = fablib._gather_plane.bytes = 0
    fablib._routed_plane.sends = fablib._routed_plane.recvs = 0
    fablib._routed_plane.bytes = 0


def phase14_rank(rank: int, world: int, data: dict, jobs: list,
                 barriers: bool) -> dict:
    """One rank of phase 14 (a gloo process group whose ranks all use
    cuda:0): each job's SHARD_ROUNDS rounds through ``stream_fn``
    (SHARD_STREAM_REPEATS calls) and its first ``job["loop"]`` rounds
    through one ``exchange_fn`` call each.  The counts are set to 0 just
    before the stream's repeats and read just after them, and the same
    around the loop; the loop must equal the stream's rounds bit for bit.
    The meshes are the card's, as a user builds them: ``fabric_mesh(plan)``
    at its default device type for the fabric jobs and a ``"cuda"``
    ``init_device_mesh`` for the legacy ones.  Returns the stream's
    outputs, wall times, launches by body and wire counters by job, and
    with ``barriers`` the barriers on the legacy jobs' star and 3 x 4
    meshes (all ready; rank 3 not ready)."""
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)            # every rank uses the one card
    # The ranks share the host's cores: one thread each for host-side work.
    torch.set_num_threads(1)
    meshes, out = {}, {}
    for job in jobs:
        dims = job["dims"]
        if dims not in meshes:
            names, shape = zip(*dims)
            meshes[dims] = (
                sharding.fabric_mesh(job["plan"]) if job["kind"] == "fabric"
                else init_device_mesh("cuda", shape, mesh_dim_names=names))
            if meshes[dims].device_type != "cuda":
                raise AssertionError(f"{dims}: a "
                                     f"{meshes[dims].device_type} mesh")
        mesh = meshes[dims]
        d = data[job["data"]]
        frames = EventFrame(*(torch.from_numpy(d[k][:, rank]).to(DEV)
                                     for k in ("labels", "times", "valid")))
        args = [torch.from_numpy(d[k][rank]).to(DEV) for k in ("fwd", "rev")]
        if job["kind"] == "fabric":
            ic = fablib.FabricInterconnect(
                mesh, job["plan"], timing=job["timing"],
                health=health_on(job["health"], job["plan"], DEV))
            stream_fn, exchange_fn = ic.stream_fn(), ic.exchange_fn()
        else:
            ic = agg.StarInterconnect(mesh, "chip", timing=job["timing"],
                                      **job["star"])
            stream_fn, exchange_fn = ic.stream_fn(), ic.exchange_fn()
            args += [torch.from_numpy(e).to(DEV) for e in job["enables"]]
        rounds = [EventFrame(*(x[t] for x in frames))
                  for t in range(job["loop"])]
        exchange_fn(rounds[0], *args)                  # warm: load, connect
        res = dict(stream_s=[])
        reset_counts(ops.fused_merge_pack)
        reset_shard_wire()
        for _ in range(SHARD_STREAM_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o, dr = stream_fn(frames, *args)
            torch.cuda.synchronize()
            res["stream_s"].append(time.perf_counter() - t0)
        res["stream_paths"] = dict(ops.fused_merge_pack.launches_by_path)
        res["stream_wire"] = shard_wire()
        reset_counts(ops.fused_merge_pack)
        reset_shard_wire()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop = [exchange_fn(fr, *args) for fr in rounds]
        torch.cuda.synchronize()
        res["loop_s"] = time.perf_counter() - t0
        res["loop_paths"] = dict(ops.fused_merge_pack.launches_by_path)
        res["loop_wire"] = shard_wire()
        stream = (*o, *dr)
        for i, name in enumerate(SHARD_FIELDS):
            got = torch.stack([(*lo, *ld)[i] for lo, ld in loop])
            if not torch.equal(got, stream[i][:job["loop"]]):
                raise AssertionError(f"rank {rank} {job['key']}: "
                                     f"{job['loop']} exchange_fn calls != "
                                     f"stream_fn's rounds ({name})")
        res["out"] = [x.cpu().numpy() for x in stream]
        out[job["key"]] = res
    if barriers:
        star = meshes[(("chip", world),)]
        hier = meshes[(("pod", 3), ("chip", 4))]
        out["barrier"] = [
            bool(sync.barrier(torch.tensor(ready, device=DEV), axis, mesh))
            for ready, axis, mesh in ((True, "chip", star),
                                      (rank != 3, "chip", star),
                                      (rank != 3, "chip", hier),
                                      (rank != 3, "pod", hier))]
    return out


def fabric_jobs(name: str, plan, data: str, health_specs: dict,
                loop: int) -> list:
    """Phase 14's fabric jobs on ``plan``: every health variant in
    ``health_specs`` (variant -> (plan, overlay)), gather and routed,
    untimed and timed, with ``loop`` rounds through ``exchange_fn``."""
    dims = tuple((f"fab{i}", f) for i, f in reversed(list(enumerate(
        plan.fan_ins))))
    jobs = []
    for variant, (vplan, overlay) in health_specs.items():
        for mode in fablib.EXCHANGE_MODES:
            for timed in (False, True):
                jobs.append(dict(
                    key=f"{name}/{variant}/{mode}/"
                        f"{'timed' if timed else 'untimed'}",
                    kind="fabric", dims=dims, data=data, loop=loop,
                    plan=fablib.with_exchange_mode(vplan, mode),
                    timing=timed_wire() if timed else None, health=overlay))
    return jobs


def stacked_reference(job, d: dict, device) -> list:
    """The job's rounds through the stacked executor on ``device`` (batch
    = rounds): ``fabric_route_step`` on the job's plan, ``route_step``
    (congestion only; the other drops 0) for the plain star, and
    ``route_step_hierarchical`` for the hierarchy."""
    frames = EventFrame(*(torch.from_numpy(d[k]).to(device)
                                 for k in ("labels", "times", "valid")))
    fwd, rev = (torch.from_numpy(d[k]).to(device) for k in ("fwd", "rev"))
    if job["kind"] == "fabric":
        out, drops = fablib.fabric_route_step(
            agg.RouterState(fwd, rev, None), frames, job["plan"],
            timing=job["timing"],
            health=health_on(job["health"], job["plan"], device))
        return [x.cpu().numpy() for x in (*out, *drops)]
    star = job["star"]
    en = [torch.from_numpy(e).to(device) for e in job["enables"]]
    state = agg.RouterState(fwd, rev, en[0])
    if len(en) == 2:
        out, drops = agg.route_step_hierarchical(
            state, frames, star["capacity"], n_pods=en[1].shape[0],
            intra_enables=en[0], inter_enables=en[1],
            link_capacity=star.get("link_capacity"),
            pod_capacity=star.get("pod_capacity"), timing=job["timing"])
    elif star.get("link_capacity") is None:
        out, congestion = agg.route_step(state, frames, star["capacity"],
                                         timing=job["timing"])
        zero = torch.zeros_like(congestion)
        drops = (congestion, zero, zero, zero)
    else:
        # route_step takes no link capacity: its plan with the lane cap.
        out, drops = fablib.fabric_route_step(
            state, frames, fablib.compile_fabric(fablib.star_spec(
                en[0].shape[0], star["capacity"], enables=en[0],
                link_capacity=star["link_capacity"])), timing=job["timing"])
    return [x.cpu().numpy() for x in (*out, *drops)]


def job_plan(job):
    """The plan a job's round compiles (the legacy jobs' from their
    enables, as ``star_exchange`` / ``hierarchical_exchange`` do)."""
    if job["kind"] == "fabric":
        return job["plan"]
    star = job["star"]
    en = job["enables"]
    if len(en) == 1:
        return fablib.compile_fabric(fablib.star_spec(
            en[0].shape[0], star["capacity"], enables=en[0],
            link_capacity=star.get("link_capacity")))
    return fablib.compile_fabric(fablib.hierarchical_spec(
        n_pods=en[1].shape[0], per_pod=en[0].shape[0],
        capacity=star["capacity"], intra_enables=en[0], inter_enables=en[1],
        link_capacity=star.get("link_capacity"),
        pod_capacity=star.get("pod_capacity")))


def phase14_group(world: int, data: dict, jobs: list, launches: dict,
                  gpu: str, barriers: bool = False) -> list:
    """Runs ``jobs`` on ``world`` gloo ranks sharing the card, checks every
    rank against the stacked executor on the card and on the CPU, the
    launches by body and the wire counters, prints a line per job and adds
    the ranks' launches to ``launches``.  Returns the ranks' results."""
    from repro_torch.parallel.spawn import run_ranks

    t0 = time.perf_counter()
    ranks = run_ranks(phase14_rank, world, data, jobs, barriers,
                      timeout_s=600)
    ranks_s = time.perf_counter() - t0
    for job in jobs:
        d = data[job["data"]]
        plan = job_plan(job)
        cap_in = d["labels"].shape[-1]
        timed = job["timing"] is not None
        # [rank, round, ...] -> [round, rank, ...], the stacked layout.
        got = [np.swapaxes(np.stack([r[job["key"]]["out"][i] for r in ranks]),
                           0, 1) for i in range(len(SHARD_FIELDS))]
        for side, dev in (("card", DEV), ("CPU", torch.device("cpu"))):
            want = stacked_reference(job, d, dev)
            for name, g, w in zip(SHARD_FIELDS, got, want, strict=True):
                if not np.array_equal(g, w):
                    raise AssertionError(
                        f"{job['key']}: {name} of the {world} ranks != the "
                        f"stacked executor on the {side}")
        merged = sum(map(sum, plan.merge_layout(cap_in)))
        body = f"merge_pack {ops.merge_pack_body_for(merged)}"
        levels = wire_per_level(plan, cap_in, timed)
        routed = plan.exchange_mode == "routed"
        for rank, r in enumerate(ranks):
            res = r[job["key"]]
            for what, paths, n in (("stream_fn", res["stream_paths"],
                                    SHARD_STREAM_REPEATS),
                                   ("exchange_fn loop", res["loop_paths"],
                                    job["loop"])):
                paths = {f"merge_pack {k}": v for k, v in paths.items() if v}
                if paths != {body: n}:
                    raise AssertionError(f"{job['key']} rank {rank} {what}: "
                                         f"launches by body {paths}, "
                                         f"expected {{{body!r}: {n}}}")
            wire = res["loop_wire"]
            moved = wire["p2p_bytes"] if routed else wire["gather_bytes"]
            if (moved != job["loop"] * sum(levels)
                    or (routed and wire["gathers"])
                    or (not routed and wire["sends"])):
                raise AssertionError(f"{job['key']} rank {rank}: wire "
                                     f"{wire}, expected {sum(levels)} B a "
                                     f"round by {plan.exchange_mode}")
            launches["merge_pack"] += (sum(res["stream_paths"].values())
                                       + sum(res["loop_paths"].values()))
        stream_us = [np.median(r[job["key"]]["stream_s"]) / SHARD_ROUNDS
                     * 1e6 for r in ranks]
        loop_us = [r[job["key"]]["loop_s"] / job["loop"] * 1e6
                   for r in ranks]
        drops = ", ".join(f"{n} {int(g.sum())}" for n, g in
                          zip(SHARD_FIELDS[3:], got[3:]))
        print(f"phase 14: {job['key']}: {world} gloo ranks on the card, "
              f"{SHARD_ROUNDS} rounds (cap_in {cap_in}); every rank == the "
              f"stacked executor on the card and on the CPU bit for bit "
              f"({int(got[2].sum())} events delivered; {drops}); "
              f"{job['loop']} exchange_fn calls == stream_fn's first "
              f"{job['loop']} rounds; launches per rank: {body} "
              f"x{SHARD_STREAM_REPEATS} over {SHARD_STREAM_REPEATS} stream_fn "
              f"calls, x{job['loop']} the loop; "
              f"{plan.exchange_mode}: {wire['gathers']} all-gathers, "
              f"{wire['sends']} sends a rank over the loop, wire bytes "
              f"received a rank a round by level {levels} (transport gloo "
              f"through host memory); us a round a rank (median, max over "
              f"ranks): stream_fn {np.median(stream_us):.1f}, "
              f"{max(stream_us):.1f}; exchange_fn {np.median(loop_us):.1f}, "
              f"{max(loop_us):.1f} [{gpu}]", flush=True)
    print(f"phase 14: {len(jobs)} jobs on {world} ranks sharing the card "
          f"(gloo; NCCL needs a card per rank) in {ranks_s:.1f} s [{gpu}]",
          flush=True)
    return ranks


def phase14(launches: dict, gpu: str) -> None:
    # (a) FULL_BACKPLANE at full width on 12 ranks, both occupancies; (c)
    # the legacy star on 12 ranks and the hierarchy on 3 x 4.
    _, fan_ins, cap_in, cap = next(c for c in scenarios.CASES
                                   if c[0] == "FULL_BACKPLANE")
    n = fan_ins[0]
    data, jobs = {}, []
    plan = scenarios.plan_for(fan_ins, cap, scenarios.level_caps(
        fan_ins, cap_in, OCC))
    for occ in SHARD_OCCS:
        key = f"FULL_BACKPLANE@{occ:g}"
        data[key] = shard_inputs(14, n, cap_in, occ)
        jobs += fabric_jobs(key, plan, key, {"healthy": (plan, None)},
                            loop=SHARD_ROUNDS)
    star_en = ~np.eye(n, dtype=bool)
    intra, inter = ~np.eye(4, dtype=bool), np.ones((3, 3), bool)
    legacy = (("star", dict(capacity=cap), (star_en,), None),
              ("star/link 16", dict(capacity=cap, link_capacity=16),
               (star_en,), None),
              ("hier 3x4", dict(capacity=cap, pod_axis="pod"),
               (intra, inter), None),
              ("hier 3x4/link 16, pod 48",
               dict(capacity=cap, pod_axis="pod", link_capacity=16,
                    pod_capacity=48), (intra, inter), None),
              ("hier 3x4/link 16, pod 48/timed",
               dict(capacity=cap, pod_axis="pod", link_capacity=16,
                    pod_capacity=48), (intra, inter), timed_wire()))
    for name, star, enables, timing in legacy:
        dims = ((("chip", n),) if len(enables) == 1
                else (("pod", 3), ("chip", 4)))
        jobs.append(dict(key=f"StarInterconnect {name}", kind="star",
                         dims=dims, data=f"FULL_BACKPLANE@{SHARD_OCCS[1]:g}",
                         loop=SHARD_LOOP_SHORT,
                         star=star, enables=enables, timing=timing))
    ranks = phase14_group(n, data, jobs, launches, gpu, barriers=True)
    for rank, r in enumerate(ranks):
        pod, chip = divmod(rank, 4)
        want = [True, False, pod != 0, chip != 3]
        if r["barrier"] != want:
            raise AssertionError(f"barrier on rank {rank}: {r['barrier']}, "
                                 f"expected {want}")
    print(f"phase 14: barrier on {n} ranks (ready on the card): all ready -> "
          f"released on every rank; rank 3 not ready -> held on the star, "
          f"held only in rank 3's pod (chip axis) and chip column (pod axis) "
          f"of the 3 x 4 hierarchy [{gpu}]", flush=True)

    # (b) The 3-level twin of EXT_4CASE_96CHIP on 8 ranks, degraded.
    _, _, ext_cap_in, ext_cap = next(c for c in scenarios.CASES
                                     if c[0] == "EXT_4CASE_96CHIP")
    twin = scenarios.plan_for(EXT_TWIN, ext_cap, scenarios.level_caps(
        EXT_TWIN, ext_cap_in, OCC))
    variants = {v: (fablib.compile_fabric(fablib.degrade_spec(twin.spec, dead))
                    if dead else twin, None)
                for v, dead in scenarios.DEGRADED_VARIANTS}
    variants["overlay"] = (twin, {("uplink", 1): (1,), ("downlink", 0): (5,)})
    key = "EXT_TWIN_2x2x2@0.5"
    data = {key: shard_inputs(15, math.prod(EXT_TWIN), ext_cap_in, 0.5)}
    phase14_group(math.prod(EXT_TWIN), data,
                  fabric_jobs(key, twin, key, variants, loop=SHARD_LOOP_SHORT),
                  launches, gpu)


# ---------------------------------------------------------------------------
# Phase 15: the dense surrogate path and surrogate-gradient training
# ---------------------------------------------------------------------------

# Networks: name -> (chips, T, train steps), all at capacity 600 >= 512
# events a destination, so a feed-forward event run drops nothing and can
# equal the dense run.  A is examples/multichip_snn.py's training network
# and B one backplane, both run dense against event and trained.  R is
# the network of tests/test_snn.py::test_multichip_training_reduces_loss,
# the one the reference holds to its loss criterion; A and B report their
# losses (A's last chip fires about half the time and max|g| is about
# 3e-5, so at lr 0.2 its loss stays near ln 4 over 60 steps).
TRAIN_RUNS = {"A": (3, 32, 60), "B": (12, 64, 10), "R": (2, 24, 30)}
TRAIN_BATCH, TRAIN_LR = 16, 0.2
# The first train step, card against CPU: the gradient and momentum within
# 1e-5 x max|g| (cuBLAS and the CPU sum the backward products in other
# orders); the weights, w - lr*m rounded to float32, within lr times that
# plus one float32 ulp of the weight.
GRAD_TOL = 1e-5


def train_config(n_chips: int, n_steps: int) -> training.TrainConfig:
    return training.TrainConfig(
        network=netlib.NetworkConfig(n_chips=n_chips, capacity=600),
        n_steps=n_steps, n_classes=4, lr=TRAIN_LR)


def zero_momentum(params):
    return params._replace(chips=params.chips._replace(
        weights=torch.zeros_like(params.chips.weights)))


def other_launches() -> dict:
    """The kernels no run_stream path launches: their total counts."""
    return {"spike_router": ops.route_and_pack.launches,
            "exchange_stream": ops.fused_exchange_stream.launches,
            "lif_step": lif_ops.lif_step.launches}


def dense_run(params, cfg, drives, mats, device, state=None):
    return stream.run_stream(
        params, netlib.init_state(cfg, drives.shape[2], device=device)
        if state is None else state, drives, cfg, mode="dense",
        route_mats=mats, device=device)


def dense_card_vs_cpu(params, cfg, drives, mats, card_out) -> dict:
    """The dense run on the card against the same run on the CPU, by the
    flip rule (``parity.compare_streams``)."""
    cpu = torch.device("cpu")
    p_c, d_c, m_c = netlib.to_device(params, cpu), drives.cpu(), mats.cpu()
    state = netlib.init_state(cfg, drives.shape[2], device=cpu)
    ref = dense_run(p_c, cfg, d_c, m_c, cpu, state)

    def margin_at(t):
        before = dense_run(p_c, cfg, d_c[:t], m_c, cpu, state).state
        return parity.spike_margin(p_c, before, d_c[t], cfg)

    return parity.compare_streams(ref, card_out, margin_at)


def phase15_dense(launches: dict, gpu: str) -> None:
    """(a): dense against event, and the card against the CPU, on dyadic
    weights (the card's float state is then the CPU's)."""
    for name in ("A", "B"):
        n, steps, _ = TRAIN_RUNS[name]
        cfg = train_config(n, steps)
        net = cfg.network
        params = dyadic(netlib.init_feedforward(net, seed=15, device=DEV))
        t0 = time.perf_counter()
        mats = netlib.routing_matrices(params, net)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        drives, _ = training.make_batch(
            cfg, TRAIN_BATCH, generator=torch.Generator(DEV).manual_seed(15),
            device=DEV)
        state = netlib.init_state(net, TRAIN_BATCH, device=DEV)
        body = ops.exchange_body_for(n, net.capacity, n)

        def dense(d=drives, p=params, c=net, m=mats, s=state):
            return dense_run(p, c, d, m, DEV, s)

        def event(d=drives, p=params, c=net, s=state):
            return stream.run_stream(p, s, d, c, device=DEV)

        dense(drives[:4]), event(drives[:4])                 # warm-up
        before = other_launches()
        outs, rates = in_turns(
            {"event": event, "dense": dense}, launches,
            {"event": {f"exchange {body}": steps}, "dense": {}}, rounds=3,
            steps=steps)
        if other_launches() != before:
            raise AssertionError(f"{name}: a spike-router, stream or LIF "
                                 f"kernel launched: {other_launches()}")
        d, e = outs["dense"], outs["event"]
        if int(e.dropped.sum()) or int(e.uplink_dropped.sum()):
            raise AssertionError(f"{name}: the event run dropped events")
        parity.assert_equal(f"{name} dense against event spikes", e.spikes,
                            d.spikes)
        parity.assert_equal(f"{name} dense against event delay line",
                            e.state.inflight, d.state.inflight)
        for f in ("dropped", "uplink_dropped", "unroutable", "rerouted"):
            x = getattr(d, f)
            if x.dtype != torch.int32 or x.shape != e.dropped.shape or \
                    bool(x.any()):
                raise AssertionError(f"{name} dense {f}: {x.dtype} "
                                     f"{tuple(x.shape)}, not zeros")
        per_chip = d.spikes.sum(dim=(0, 2, 3)).long().tolist()
        if not per_chip[-1]:
            raise AssertionError(f"{name}: no spike reached the last chip")
        report = dense_card_vs_cpu(params, net, drives, mats, d)
        print(f"phase 15: {name}: {n} chips x {net.chip.n_neurons} neurons "
              f"x {net.chip.n_rows} rows, batch {TRAIN_BATCH}, {steps} "
              f"steps, route_mats {mats.numel() * 4 / 1e6:.1f} MB built in "
              f"{build_ms:.1f} ms; dense == event bit for bit (spikes, "
              f"delay line; event dropped 0; dense statistics all zero "
              f"int32); spikes by chip {per_chip}; launches by body: event "
              f"{{'exchange {body}': {steps}}}, dense none (no spike-router, "
              f"stream or LIF kernel either); card == CPU ("
              f"{len(report['flips'])} near-threshold flips "
              f"{report['flips'][:5]}, final state max err "
              f"{report['state_max_err']}); steps/s in turns (event, dense, "
              f"dense, event) x 3: event "
              f"{', '.join(f'{r:.1f}' for r in rates['event'])}; dense "
              f"{', '.join(f'{r:.1f}' for r in rates['dense'])} [{gpu}]",
              flush=True)
        for what, fn in (("dense", dense), ("event", event)):
            print(f"phase 15: {name} {what}: " + device_breakdown(
                lambda f=fn: f(drives[:PROFILE_STEPS]),
                ours=("gemm", "exchange")) + f" [{gpu}]", flush=True)


def first_step_vs_cpu(params, mats, drives, labels, cfg) -> dict:
    """The first train step on the card against the CPU on the same batch:
    the forward rasters' near-threshold flips (``dense_card_vs_cpu``
    without its state tolerance), and the loss's relative error, the
    gradient's (the momentum after one step) and the new weights' errors
    over max|g|."""
    cpu = torch.device("cpu")
    p_c = netlib.to_device(params, cpu)
    fwd = [training.forward_rates(p, mats, drives, cfg, TRAIN_BATCH,
                                  device=dev)[1].cpu()
           for dev, p in ((cpu, p_c), (DEV, params))]
    differs = [t for t in range(fwd[0].shape[0])
               if not torch.equal(fwd[0][t], fwd[1][t])]
    flips = []
    if differs:
        t = differs[0]
        before = dense_run(p_c, cfg.network, drives[:t].cpu(), mats.cpu(),
                           cpu).state
        margin = parity.spike_margin(p_c, before, drives[t].cpu(),
                                     cfg.network)
        flips = [(t, *(int(i) for i in k), float(margin[tuple(k)]))
                 for k in torch.nonzero(fwd[0][t] != fwd[1][t])]
    (p_0, m_0, loss_0, _), (p_1, m_1, loss_1, _) = (
        training.train_step(p, zero_momentum(p), mats, drives, labels, cfg,
                            device=dev)
        for dev, p in ((cpu, p_c), (DEV, params)))
    g = m_0.chips.weights
    scale = float(g.abs().max())
    w_0 = p_0.chips.weights
    w_err = (p_1.chips.weights.cpu() - w_0).abs()
    w_bound = (cfg.lr * GRAD_TOL * scale
               + torch.from_numpy(np.spacing(w_0.abs().numpy())))
    return {"flips": flips, "max_g": scale,
            "loss": abs(float(loss_1) - float(loss_0)) / abs(float(loss_0)),
            "g": float((m_1.chips.weights.cpu() - g).abs().max()) / scale,
            "w": float(w_err.max()),
            "w_within": bool((w_err <= w_bound).all())}


def dyadic(params):
    """``params`` at w_scale 2^-8 (the init's is 4 / (63 x 16)): every
    synapse-product term is then a multiple of 2^-8 and the sums are exact
    in any order, so the card's forward is the CPU's bit for bit (phases 4
    and 12 do the same)."""
    return params._replace(chips=params.chips._replace(
        w_scale=torch.full_like(params.chips.w_scale, 2.0 ** -8)))


def phase15_train(name: str, gpu: str) -> None:
    """(b) and (c): the train steps of ``TRAIN_RUNS[name]`` on card
    batches."""
    n, steps, n_train = TRAIN_RUNS[name]
    cfg = train_config(n, steps)
    init = netlib.init_feedforward(cfg.network, seed=0, device=DEV)
    # A trains the dyadic twin, whose first step the card must match.
    params = dyadic(init) if name == "A" else init
    mats = netlib.routing_matrices(params, cfg.network)
    mom = zero_momentum(params)
    # R takes the batches of tests/test_torch_training.py's run of the
    # same network (a CPU generator seeded 100 + i), A and B a card's.
    gens = ([torch.Generator().manual_seed(100 + i) for i in range(n_train)]
            if name == "R" else
            [torch.Generator(DEV).manual_seed(25)] * n_train)
    batches = [training.make_batch(cfg, TRAIN_BATCH, generator=g, device=DEV)
               for g in gens]
    if name == "A":
        # The first step, card against CPU: held on the dyadic network
        # trained here; measured, not held, at the init's own w_scale,
        # where the two devices' float sums differ.
        check = first_step_vs_cpu(params, mats, *batches[0], cfg)
        if (check["flips"] or check["loss"] > 1e-6
                or check["g"] > GRAD_TOL or not check["w_within"]):
            raise AssertionError(f"A: first train step, card against CPU: "
                                 f"{check}")
        loose = first_step_vs_cpu(init, mats, *batches[0], cfg)
    training.train_step(params, mom, mats, *batches[0], cfg,
                        device=DEV)                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    reset_snn_counts()
    before = other_launches()
    losses, ms = [], []
    for drives, labels in batches:
        t0 = time.perf_counter()
        params, mom, loss, aux = training.train_step(params, mom, mats,
                                                     drives, labels, cfg,
                                                     device=DEV)
        losses.append(float(loss))                           # synchronises
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(DEV)
    if any(snn_paths().values()) or other_launches() != before:
        raise AssertionError(f"{name}: training launched an SNN kernel")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: loss not finite: {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    chip = cfg.network.chip
    max_m = float(mom.chips.weights.abs().max())
    line = (f"phase 15: {name} training, {n} chips x {chip.n_neurons} x "
            f"{chip.n_rows}, T {steps}, "
            f"batch {TRAIN_BATCH}, lr {TRAIN_LR}: {len(losses)} train steps "
            f"at {float(np.median(ms)):.1f} ms a step (median; min "
            f"{min(ms):.1f}, max {max(ms):.1f}), peak device memory "
            f"{peak / 2 ** 30:.2f} GiB; loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} (mean of the first 5 {first:.4f}, last 5 "
            f"{last:.4f}), acc {float(aux['acc']):.3f}, rate "
            f"{float(aux['rate']):.4f}, max |momentum| {max_m:.3g}; no SNN "
            f"kernel launched")
    if name == "R":
        if not last < first:
            raise AssertionError(f"R: training did not reduce the loss: "
                                 f"{losses}")
        line += "; the loss fell (the reference test's criterion)"
    if name == "A":
        line += (f"; first step, card against CPU: rasters equal, loss "
                 f"rel err {check['loss']:.3g}, gradient and momentum max "
                 f"err {check['g']:.3g} x max|g| ({check['max_g']:.4g}), "
                 f"new weights max err {check['w']:.3g} (within lr x "
                 f"{GRAD_TOL} x max|g| + 1 ulp); at the init's own w_scale "
                 f"(not held): {len(loose['flips'])} flips "
                 f"{loose['flips'][:3]}, loss rel err {loose['loss']:.3g}, "
                 f"gradient max err {loose['g']:.3g} x max|g|")
    print(line + f" [{gpu}]", flush=True)
    if name == "A":
        print(f"phase 15: A train step: " + device_breakdown(
            lambda: training.train_step(params, mom, mats, *batches[-1], cfg,
                                        device=DEV),
            per=1, unit="train step", ours=("gemm",)) + f" [{gpu}]",
            flush=True)


def phase15(launches: dict, gpu: str) -> None:
    phase15_dense(launches, gpu)
    for name in TRAIN_RUNS:
        phase15_train(name, gpu)


# ---------------------------------------------------------------------------
# Phase 16: the fabric verifier on the card
# ---------------------------------------------------------------------------

# The router kernels' wrappers by kernel name.
ROUTER_WRAPPERS = {"spike_router": ops.route_and_pack,
                   "merge_pack": ops.fused_merge_pack,
                   "exchange": ops.fused_exchange,
                   "exchange_stream": ops.fused_exchange_stream}


# The card check under compute-sanitizer: memcheck for out-of-bounds and
# misaligned accesses of every body, racecheck for the shared-memory scans
# (pack.cuh's block_rank and the block scans).  Run in a child process with
# the kernels built; it must exit 0 where the sanitizer supports the card.
SANITIZED_CHECK = ("import sys; sys.path.insert(0, 'src'); "
                   "from repro_torch.analysis import kernelcheck as kc; "
                   "d = kc.check_router_kernels('cuda'); "
                   "sys.exit('\\n'.join(x.format() for x in d) or None)")
SANITIZER_TIMEOUT_S = 600


def sanitized_card_check(gpu: str) -> None:
    """Runs the card check under ``compute-sanitizer --tool memcheck`` and
    ``--tool racecheck`` (``--error-exitcode 1``).  A toolkit without the
    sanitizer, or a sanitizer that refuses the device, is printed as such:
    the output checks of ``run_lint`` then stand alone."""
    tool = pathlib.Path("/usr/local/cuda/bin/compute-sanitizer")
    if not tool.exists():
        print(f"phase 16: compute-sanitizer: not in the toolkit; the card "
              f"check's output checks stand alone [{gpu}]", flush=True)
        return
    version = subprocess.run([str(tool), "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()[-1]
    root = pathlib.Path(__file__).resolve().parent
    for what in ("memcheck", "racecheck"):
        t0 = time.perf_counter()
        run = subprocess.run(
            [str(tool), "--tool", what, "--error-exitcode", "1",
             sys.executable, "-c", SANITIZED_CHECK], cwd=root,
            capture_output=True, text=True, timeout=SANITIZER_TIMEOUT_S)
        out = run.stdout + run.stderr
        if "Device not supported" in out:
            print(f"phase 16: compute-sanitizer ({version}) {what}: the "
                  f"sanitizer refuses this card (\"Error: Device not "
                  f"supported\") and the checked process then fails its "
                  f"first allocation, so nothing ran under it; the card "
                  f"check's output checks stand alone [{gpu}]", flush=True)
            return
        if run.returncode:
            raise AssertionError(f"compute-sanitizer {what} of the card "
                                 f"check exited {run.returncode}:\n"
                                 f"{out[-3000:]}")
        summary = [line for line in out.splitlines() if "SUMMARY" in line]
        print(f"phase 16: compute-sanitizer ({version}) {what} of the card "
              f"check: exit 0, {summary} in "
              f"{time.perf_counter() - t0:.1f} s [{gpu}]", flush=True)


def phase16(launches: dict, gpu: str) -> None:
    """``analysis.lint.run_lint(device="cuda")`` over the whole catalogue:
    the plan verifier, the program lint (route steps on the card, the
    sharded twins on gloo ranks sharing the card, run_stream), the pack
    units' model check and the card check of every body of the four
    router kernels.  Fails on any error; counts this process's launches
    (the ranks' merge_pack launches are theirs)."""
    from repro_torch.analysis import kernelcheck, lint
    from repro_torch.analysis.diagnostics import WARNING, apply_suppressions
    from repro_torch.analysis.suppressions import SUPPRESSIONS

    for w in ROUTER_WRAPPERS.values():
        reset_counts(w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seconds: dict = {}
    findings = lint.run_lint(device="cuda", seconds=seconds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    active, suppressed = apply_suppressions(findings, SUPPRESSIONS)
    for d in active:
        print(f"phase 16: {d.format()}", flush=True)
    per_check = dict(sorted(collections.Counter(
        f"{d.check} ({d.severity})" for d in active).items()))
    paths = {f"{k} {b}": n for k, w in ROUTER_WRAPPERS.items()
             for b, n in w.launches_by_path.items() if n}
    bodies = {f"{k} {kernelcheck.card_body(k, s)}"
              for k, s, _ in kernelcheck.CARD_CASES}
    for k, w in ROUTER_WRAPPERS.items():
        launches[k] += w.launches
    print(f"phase 16: fabric lint on the card: {len(findings)} findings, "
          f"{len(suppressed)} suppressed; per check {per_check}; "
          f"{len(kernelcheck.CARD_CASES) + 4} card cases over "
          f"{len(bodies)} kernel bodies {sorted(bodies)}; launches by body "
          f"in this process {paths}; wall time {wall:.1f} s, by pass "
          f"{ {k: round(v, 2) for k, v in seconds.items()} } [{gpu}]",
          flush=True)
    errors = [d for d in active if d.severity != WARNING]
    if errors:
        raise AssertionError(f"fabric lint: {len(errors)} error(s): "
                             f"{[d.format() for d in errors[:5]]}")
    if missing := {b for b in bodies if not paths.get(b)}:
        raise AssertionError(f"the card check never ran {sorted(missing)}")
    sanitized_card_check(gpu)


# ---------------------------------------------------------------------------
# Phase 17: the RWKV6, dense and MoE families served at full width
# ---------------------------------------------------------------------------

# (arch, layers run or None for full depth).  Every config runs at full
# width with float32 parameters (count_params x 4: rwkv6-7b 30.1 GB,
# smollm-135m 0.5, gemma-7b 34.2, qwen3-8b 32.8, phi3-medium-14b 58.6);
# grok-1-314b at 2 of its 64 layers, 45.8 GB (each layer's 8 experts take
# 19.3 GB in float32).
FAMILIES = (("rwkv6-7b", None), ("smollm-135m", None), ("gemma-7b", None),
            ("qwen3-8b", None), ("phi3-medium-14b", None),
            ("grok-1-314b", 2))
FAMILY_PEAK_LIMIT = 70 * 2**30   # phi3-medium-14b runs at full depth within it
# The card against the CPU: 2 full-width layers, float32 on both sides
# (the kernels' f32 and per-channel bodies); cuBLAS and the kernels sum in
# another order than the CPU's BLAS and the plain versions.  Logits as
# phase 6; every cache leaf within 1e-4 of its largest value.
# The MoE checks (grok-1-314b: 45.8 GB of float32 parameters on each side;
# deepseek-v2-236b in phase 18: 21.4 GB) put a first prompt row of token
# 0, whose embedding is zeroed: the router then sees zero rows and gives
# every expert exactly the same probability, so the card's top-k must
# break the tie as the CPU's does (lower index first), and the tied events
# fill the first experts to capacity, so events drop.  Each MoE layer must
# drop the same number of events on both sides.
FAMILY_CHECKS = ("rwkv6-7b", "gemma-7b", "grok-1-314b")
FAMILY_CHECK_LAYERS = 2
FAMILY_CACHE_TOL = 1e-4
# The attention configs whose prefill shape family_kernels checks.
FLASH_FAMILIES = ("gemma-7b", "smollm-135m", "qwen3-8b", "phi3-medium-14b",
                  "grok-1-314b")


def family_kernels(gpu: str) -> None:
    """Each kernel on the shape a new family's prefill gives it, against
    its plain version; time per launch, plain time, bound and SDPA's."""
    gen = torch.Generator(device=DEV).manual_seed(17)
    bf16 = torch.bfloat16
    args = rwkv_inputs(gen, 4, 64, 2048, 64, bf16, views=True)
    name = "rwkv6-7b main path: b4 h64 t2048 k64 v64 bf16 bonus"
    err = scan_check(name, args, "bonus", "channel_decay",
                     (BF16_ULP, 1e-3, SCAN_TC_REASON), "17")
    b_ms, b_by = scan_bound(*args)
    # The body takes 64 value columns a block where they divide V (the
    # launch's registers are in the build's ptxas line).
    per_sm, smem = scan_ops.channel_decay_occupancy(args[0].shape[-1],
                                                    args[2].shape[-1])
    grid = args[0].shape[0] * args[0].shape[1] * (args[2].shape[-1] // 64)
    ms = graph_ms(lambda: scan_ops.linear_scan(*args, mode="bonus"), 10, 5)
    chunk = scan_ops.chunk_for(args[0].shape[2])
    plain = eager_ms(lambda: linear_scan_chunked(*args, mode="bonus",
                                                 chunk=chunk), 2, 1)
    twin = eager_ms(lambda: linear_scan_channel_decay_ref(*args,
                                                          mode="bonus"), 2, 1)
    print(f"phase 17: linear_scan {name} (channel_decay, 64-column V "
          f"slice: {smem} B shared memory, {per_sm} blocks an SM, {grid} "
          f"blocks = {grid / (per_sm * SMS):.2f} waves): kernel {ms:.4f} ms "
          f"(graph replay), plain {plain:.4f} ms (linear_scan_chunked), twin "
          f"{twin:.4f} ms (linear_scan_channel_decay_ref), library none, "
          f"bound {b_ms:.4f} ms ({b_by}), max abs err {err:.3g} [{gpu}]",
          flush=True)
    del args
    for arch in FLASH_FAMILIES:
        cfg = get_config(arch)
        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        name = (f"{arch} main path: b{LM_BATCH} h{hq}/{hkv} s{LM_PROMPT} "
                f"d{d} bf16 causal")
        shape = (LM_BATCH, hq, hkv, LM_PROMPT, d, bf16, True)
        q, k, v = flash_inputs(gen, *shape)
        err = flash_check(name, q, k, v, True, "wgmma", "17")
        b_ms, b_by = flash_bound(q, k, v)
        ms = flash_ms(q, k, v, True)
        plain = eager_ms(lambda: flash_ops.twin(q, k, v), 2, 1)
        sdpa = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 10, 5)
        print(f"phase 17: flash_attention {name} ({flash_kernel(q, k, v)}, "
              f"v a transposed view): kernel {ms:.4f} ms (graph replay), "
              f"plain {plain:.4f} ms "
              f"(attention_blocked_ref), SDPA {sdpa:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), max abs err {err:.3g} [{gpu}]",
              flush=True)
        del q, k, v
    torch.cuda.empty_cache()


def attn_launches(cfg, decode: bool = False) -> int:
    """flash_attention launches of one prefill (or one decode step): one a
    self-attention layer, and in an encoder-decoder one an encoder layer
    and one a decoder layer's cross-attention; a decode step launches only
    cross-attention's (one query row against the frames)."""
    if cfg.ssm == "rwkv6":
        return 0
    if decode:
        return cfg.n_layers if cfg.encoder_layers else 0
    return cfg.n_layers * (2 if cfg.encoder_layers else 1) + cfg.encoder_layers


def family_bodies(cfg, decode: bool = False) -> dict:
    """Launches by body of one prefill (or one decode step): RWKV6 layers
    scan through the channel-decay body (bonus mode, prefill only),
    attention runs through wgmma, a decode step's cross-attention (one
    query row) through the decode body."""
    scan = cfg.n_layers if cfg.ssm == "rwkv6" and not decode else 0
    attn = attn_launches(cfg, decode)
    return {"decode": attn if decode else 0,
            "wgmma": 0 if decode else attn, "f32": 0, "scalar_decay": 0,
            "channel_decay": scan, "per_channel": 0}


def family_inputs(cfg, batch: int, prompt: int, seed: int,
                  frames: int = 0) -> dict:
    """A prefill's inputs on the host, drawn with numpy from ``seed``:
    prompt tokens, prompt embeddings (embeddings input), or ``frames``
    frame embeddings and a decoder prompt of tokens (encoder-decoder)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_mode == "tokens" or cfg.encoder_layers:
        out["tokens"] = torch.from_numpy(rng.integers(
            1, cfg.vocab_size, (batch, prompt)).astype(np.int32))
    if cfg.input_mode == "embeddings":
        n = frames if cfg.encoder_layers else prompt
        out["embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, n, cfg.d_model), dtype=np.float32))
    return out


def prompt_len(batch: dict) -> int:
    """The decoder's prompt length: the tokens', else the embeddings'."""
    return batch["tokens" if "tokens" in batch else "embeds"].shape[1]


def greedy_decode(cfg, params, logits, dec, enc, s: int, n: int):
    """``n`` greedy decode steps from the spliced caches ``dec`` at
    position ``s``, each generated token embedded; returns (tokens [B, n],
    the last step's logits)."""
    toks = []
    tok = torch.argmax(logits, -1).to(torch.int32)
    for i in range(n):
        toks.append(tok)
        logits, dec = lm.decode_step(params, tok, dec, s + i, cfg,
                                     encoder_out=enc)
        tok = torch.argmax(logits, -1).to(torch.int32)
    return torch.stack(toks, 1), logits


def serve_family(arch: str, depth, launches: dict, gpu: str,
                 phase: str = "17") -> None:
    cfg = dataclasses.replace(get_config(arch), attention_impl="pallas")
    full = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=depth or full)
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device=DEV).manual_seed(0), cfg,
                            DEV)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    enc_layers = (f" + {cfg.encoder_layers} encoder layers"
                  if cfg.encoder_layers else "")
    print(f"phase {phase}: {arch}, {cfg.n_layers} of {full} layers"
          f"{'' if cfg.n_layers == full else ' (depth cut)'}{enc_layers}, "
          f"full width (d_model {cfg.d_model}), {n_params:.4g} float32 "
          f"parameters ({n_params * 4 / 2**30:.2f} GiB) on the card in "
          f"{time.perf_counter() - t0:.1f} s [{gpu}]", flush=True)
    # whisper's decoder prompt is the reference's s // decoder_len_ratio
    # (launch/shapes.py), against its 30-second window of frames.
    prompt = (LM_PROMPT // cfg.decoder_len_ratio if cfg.encoder_layers
              else LM_PROMPT)
    batch = {k: v.to(DEV) for k, v in family_inputs(
        cfg, LM_BATCH, prompt, 1, WHISPER_FRAMES).items()}
    shapes = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_lm_counts()
    t0 = time.perf_counter()
    tokens, stats = serve.generate(cfg, params, batch, LM_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, paths = lm_counts(), lm_paths()
    peak = torch.cuda.max_memory_allocated()
    # A warm pass (a prefill and a decode step) runs before the timed one.
    per_prefill, per_step = family_bodies(cfg), family_bodies(cfg, True)
    want = {body: 2 * n + (LM_NEW + 1) * per_step[body]
            for body, n in per_prefill.items()}
    if paths != want:
        raise AssertionError(f"{arch} serving: bodies {paths}, expected "
                             f"{want}")
    for k, n in counts.items():
        launches[k] += n
    count_lm_bodies(launches)
    if tokens.shape != (LM_BATCH, LM_NEW) or tokens.dtype != torch.int32 \
            or not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"{arch}: bad tokens {tokens.dtype}"
                             f"{tuple(tokens.shape)}")
    if arch == "phi3-medium-14b" and peak > FAMILY_PEAK_LIMIT:
        raise AssertionError(f"{arch} at {cfg.n_layers} layers peaks at "
                             f"{peak / 2**30:.2f} GiB, over "
                             f"{FAMILY_PEAK_LIMIT / 2**30:.0f} GiB")
    print(f"phase {phase}: {arch} serve.generate, batch {LM_BATCH}: {shapes} "
          f"+ {LM_NEW} new tokens (greedy, bf16 activations, warm pass "
          f"included in the {wall:.2f} s wall): prefill "
          f"{stats.prefill_s * 1e3:.1f} ms "
          f"({LM_BATCH * prompt / stats.prefill_s:.0f} prompt tokens/s), "
          f"decode {stats.decode_s / LM_NEW * 1e3:.1f} ms/step = "
          f"{stats.tokens_per_s:.1f} tokens/s, peak device memory "
          f"{peak / 2**30:.2f} GiB ({resident / 2**30:.2f} GiB resident "
          f"before the call), launches {counts}, by body {paths} [{gpu}]",
          flush=True)

    # One prefill under the profiler, then one decode step counted.
    out = {}

    def one_prefill():
        out["logits"], out["caches"], out["enc"] = lm.prefill(params, batch,
                                                               cfg)

    reset_lm_counts()
    line = device_breakdown(one_prefill, per=1, unit="prefill",
                            ours=("attn_",
                                  "scan_channel_decay_kernel"))
    print(f"phase {phase}: {arch} prefill: {line} [{gpu}]", flush=True)
    prefill_paths = lm_paths()
    dec = serve._splice_prefill(
        cfg, lm.init_cache(cfg, LM_BATCH, prompt + 1, DEV), out.pop("caches"),
        prompt)
    reset_lm_counts()
    greedy_decode(cfg, params, out["logits"], dec, out["enc"], prompt, 1)
    torch.cuda.synchronize()
    step_paths = lm_paths()
    print(f"phase {phase}: {arch} flash_attention launches: "
          f"{prefill_paths['wgmma']} wgmma and {prefill_paths['decode']} "
          f"decode a prefill, {step_paths['wgmma']} wgmma and "
          f"{step_paths['decode']} decode a decode step (predicted "
          f"{per_prefill['wgmma']}, {per_prefill['decode']}, "
          f"{per_step['wgmma']} and {per_step['decode']})", flush=True)
    if prefill_paths != per_prefill or step_paths != per_step:
        raise AssertionError(f"{arch}: one prefill launched {prefill_paths}, "
                             f"one decode step {step_paths}")
    if cfg.n_experts:
        drops = moe_drops(params, batch["tokens"], cfg, out["logits"])
        cap = moelib.expert_capacity(LM_BATCH * LM_PROMPT, cfg)
        events = LM_BATCH * LM_PROMPT * cfg.top_k
        print(f"phase {phase}: {arch} prefill dropped events by layer "
              f"{drops} of {events}, dropped_frac "
              f"{[round(d / events, 6) for d in drops]} (top-{cfg.top_k} of "
              f"{cfg.n_experts} experts, capacity factor "
              f"{cfg.capacity_factor}: {cap} events per expert)", flush=True)
    logits, enc = out["logits"], out["enc"]
    if tuple(logits.shape) != (LM_BATCH, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: prefill logits "
                             f"{tuple(logits.shape)} finite="
                             f"{bool(torch.isfinite(logits).all())}")
    if cfg.encoder_layers and (
            tuple(enc.shape) != (LM_BATCH, WHISPER_FRAMES, cfg.d_model)
            or not bool(torch.isfinite(enc).all())):
        raise AssertionError(f"{arch}: encoder_out {tuple(enc.shape)}")
    del params, logits, enc, out, dec, tokens, batch
    gc.collect()
    torch.cuda.empty_cache()


@torch.no_grad()
def moe_drops(params, prompts, cfg, logits) -> list[int]:
    """Each MoE layer's dropped events over one prefill of ``prompts``
    (``moe_forward``'s dropped share times the routed events: the share's
    last float32 bit depends on the device's division, the count does
    not), from the stack run layer by layer as ``decoder_layer`` runs it.
    Its last-position logits must equal ``logits``, the prefill's, bit for
    bit."""
    x = lm.embed_tokens(prompts, params["embed"], cfg)
    kw = dict(mode="prefill", cache=None, cache_index=None,
              positions=torch.arange(x.shape[1], device=x.device)[None, :])
    attn = (lm.attnlib.mla_forward if cfg.attention == "mla"
            else lm.attnlib.gqa_forward)
    drops = []
    for seg in lm._segments(cfg):
        for p in params[seg.name].per_layer():
            if not seg.moe:
                x, _, _ = lm.decoder_layer(p, x, cfg, moe=False, **kw)
                continue
            h, _ = attn(p["attn"], lm.apply_norm(x, p["norm1"], cfg), cfg,
                        **kw)
            x = x + h
            h, metrics = moelib.moe_forward(
                p["moe"], lm.apply_norm(x, p["norm2"], cfg), cfg)
            x = x + h
            drops.append(round(float(metrics["dropped_frac"])
                               * prompts.numel() * cfg.top_k))
    x = lm.apply_norm(x, params["final_norm"], cfg)
    again = lm.logits_from_hidden(x[:, -1], lm._head(params, cfg))
    n_moe = sum(seg.n_layers for seg in lm._segments(cfg) if seg.moe)
    if len(drops) != n_moe or not torch.equal(again, logits):
        raise AssertionError(
            f"{cfg.name}: {len(drops)} MoE layers; the layer-by-layer run's "
            f"logits differ from the prefill's by "
            f"{float((again - logits).abs().max())}")
    return drops


def family_card_vs_cpu(arch: str, phase: str = "17", new: int = 0) -> None:
    """The card against the CPU on ``arch`` at full width and 2 layers (and
    2 encoder layers), float32: prefill logits, every cache leaf, the
    encoder output, (MoE) each layer's dropped events, and with ``new``
    the greedy tokens of ``new`` decode steps and the last step's
    logits."""
    cfg = get_config(arch)
    cfg = dataclasses.replace(
        cfg, n_layers=FAMILY_CHECK_LAYERS, dtype="float32",
        encoder_layers=min(cfg.encoder_layers, FAMILY_CHECK_LAYERS),
        attention_impl="pallas")
    t0 = time.perf_counter()
    # Drawn on the card (the CPU's generator takes about 2 s a GB), then
    # copied to the host.
    card = lm.init_params(torch.Generator(device=DEV).manual_seed(5), cfg,
                          DEV)
    cpu = convert.lm_params_from_numpy(
        {n: p.cpu().numpy() for n, p in card.named_parameters()}, cfg, "cpu")
    batch = family_inputs(cfg, CHECK_BATCH, CHECK_PROMPT, 6, WHISPER_FRAMES)
    if cfg.n_experts:   # a tied first row (FAMILY_CHECKS' comment)
        batch["tokens"] = torch.cat([torch.zeros_like(batch["tokens"][:1]),
                                     batch["tokens"]])
        for params in (cpu, card):
            params["embed"].data[0] = 0.0
    sides = {"cpu": cpu, "card": card}
    s = prompt_len(batch)
    reset_lm_counts()
    res, fields = {}, []
    for side, params in sides.items():
        dev = params["embed"].device
        logits, caches, enc = lm.prefill(
            params, {k: v.to(dev) for k, v in batch.items()}, cfg)
        fields = ["logits"] + [f"{name}.{f}" for name, seg in caches.items()
                               for f in seg._fields]
        res[side] = [logits] + [c for seg in caches.values() for c in seg]
        if enc is not None:
            fields.append("encoder_out")
            res[side].append(enc)
        if new:
            dec = serve._splice_prefill(
                cfg, lm.init_cache(cfg, logits.shape[0], s + new, dev),
                caches, s)
            toks, last = greedy_decode(cfg, params, logits, dec, enc, s, new)
            fields += ["decode logits", "greedy tokens"]
            res[side] += [last, toks]
        res[side] = [t.cpu() for t in res[side]]
    paths = lm_paths()
    drops = {side: moe_drops(params, batch["tokens"].to(
        params["embed"].device), cfg, res[side][0].to(params["embed"].device))
        for side, params in sides.items()} if cfg.n_experts else {}
    errs = []
    for name, a, b in zip(fields, res["cpu"], res["card"], strict=True):
        if name == "greedy tokens":
            if not torch.equal(a, b):
                raise AssertionError(f"{arch} greedy tokens: card "
                                     f"{b.tolist()}, CPU {a.tolist()}")
            errs.append(f"{new} greedy tokens equal {b.tolist()}")
            continue
        err = float((a - b).abs().max())
        tol = CHECK_LOGIT_TOL if "logits" in name \
            else FAMILY_CACHE_TOL * float(a.abs().max())
        errs.append(f"{name} {err:.3g} (tolerance {tol:.3g})")
        if not bool(torch.isfinite(b).all()) or err > tol:
            raise AssertionError(f"{arch} {name}: card vs CPU max abs err "
                                 f"{err} > {tol}")
    # float32 operands take the CUDA-core bodies, on the card side only.
    want = {"decode": 0, "wgmma": 0, "f32": 0, "scalar_decay": 0,
            "channel_decay": 0, "per_channel": 0}
    if cfg.ssm == "rwkv6":
        want["per_channel"] = cfg.n_layers
    else:
        want["f32"] = attn_launches(cfg) + new * attn_launches(cfg, True)
    if paths != want:
        raise AssertionError(f"{arch} float32 card run went through {paths}, "
                             f"expected {want}")
    if drops:
        if drops["card"] != drops["cpu"] or not drops["cpu"][0] > 0:
            raise AssertionError(f"{arch} dropped events by layer: card "
                                 f"{drops['card']}, CPU {drops['cpu']}")
        errs.append(f"dropped events by layer {drops['card']} of "
                    f"{batch['tokens'].numel() * cfg.top_k} on both sides")
    shapes = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
    print(f"phase {phase}: {arch} full width, {FAMILY_CHECK_LAYERS} layers, "
          f"float32, {shapes}: card == CPU; max abs err {'; '.join(errs)}; "
          f"logits up to {float(res['cpu'][0].abs().max()):.3g}; bodies "
          f"{paths}; {time.perf_counter() - t0:.1f} s", flush=True)
    del cpu, card, sides, params, res
    gc.collect()
    torch.cuda.empty_cache()


def phase17(launches: dict, gpu: str) -> None:
    family_kernels(gpu)
    for arch, depth in FAMILIES:
        serve_family(arch, depth, launches, gpu)
    for arch in FAMILY_CHECKS:
        family_card_vs_cpu(arch)


# ---------------------------------------------------------------------------
# Phase 18: MLA (deepseek-v2), whisper's encoder-decoder, llava's embeddings
# ---------------------------------------------------------------------------

WHISPER_FRAMES = 1500            # n_audio_ctx: Whisper's 30-second window
# (arch, depth or None for full depth).  deepseek-v2-236b runs its dense
# first layer and one MoE layer (5.36e9 float32 parameters, 21.4 GB; all
# 60 layers would take 943 GB).
FAMILIES_18 = (("deepseek-v2-236b", 2), ("whisper-medium", None),
               ("llava-next-mistral-7b", None))


def heads_view(gen, b, h, s, d, dtype):
    """A [b, h, s, d] transposed view of a [b, s, h, d] tensor, as
    ``_split_heads`` hands q, k and v to the kernel."""
    return (torch.randn((b, s, h, d), generator=gen, device=DEV).to(dtype)
            .transpose(1, 2))


def new_shape_kernels(gpu: str) -> None:
    """flash_attention at each shape the three families' serving gives it
    for the first time, against its plain versions; time per launch, plain
    time, bound and SDPA's time."""
    gen = torch.Generator(device=DEV).manual_seed(18)
    bf16 = torch.bfloat16
    ds, wh = get_config("deepseek-v2-236b"), get_config("whisper-medium")
    dqk = ds.qk_nope_head_dim + ds.qk_rope_head_dim
    dv = ds.v_head_dim
    b, h = LM_BATCH, ds.n_heads
    # MLA: q and k concatenated (contiguous), V expanded from the latent and
    # zero-padded from v_head_dim to the q/k head dim, as mla_forward does.
    mla = tuple(torch.randn((b, h, LM_PROMPT, d), generator=gen,
                            device=DEV).to(bf16) for d in (dqk, dqk, dv))
    hw, dw, sw = wh.n_heads, wh.head_dim_, LM_PROMPT // wh.decoder_len_ratio
    frames = [heads_view(gen, b, hw, WHISPER_FRAMES, dw, bf16)
              for _ in range(2)]
    cases = (
        (f"deepseek-v2-236b MLA prefill: b{b} h{h} s{LM_PROMPT} d{dqk}, v "
         f"{dv} zero-padded to {dqk}, causal", mla, True),
        (f"whisper-medium encoder: b{b} h{hw} s{WHISPER_FRAMES} d{dw}, not "
         f"causal", (heads_view(gen, b, hw, WHISPER_FRAMES, dw, bf16),
                     *frames), False),
        (f"whisper-medium decoder self-attention: b{b} h{hw} s{sw} d{dw}, "
         f"causal", tuple(heads_view(gen, b, hw, sw, dw, bf16)
                          for _ in range(3)), True),
        (f"whisper-medium cross-attention, prefill: b{b} h{hw} q{sw} "
         f"kv{WHISPER_FRAMES} d{dw}", (heads_view(gen, b, hw, sw, dw, bf16),
                                      *frames), False),
        (f"whisper-medium cross-attention, decode: b{b} h{hw} q1 "
         f"kv{WHISPER_FRAMES} d{dw}", (heads_view(gen, b, hw, 1, dw, bf16),
                                      *frames), False),
    )
    for name, (q, k, v_raw), causal in cases:
        v = F.pad(v_raw, (0, q.shape[-1] - v_raw.shape[-1])) \
            if v_raw.shape[-1] != q.shape[-1] else v_raw
        body = flash_ops.body_for(q, k, v)
        err = flash_check(name, q, k, v, causal, body, "18")
        b_ms, b_by = flash_bound(q, k, v_raw, causal)
        ms = flash_ms(q, k, v, causal)
        plain = eager_ms(lambda: flash_ops.twin(q, k, v, causal=causal), 2, 1)
        # SDPA takes the unpadded V (dv != d) on the card.
        sdpa = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v_raw, is_causal=causal), 10, 5)
        note = "unpadded V" if v is not v_raw else "same operands"
        twin_name = ("attention_split_ref" if body == "decode"
                     else "attention_blocked_ref")
        print(f"phase 18: flash_attention {name} ({flash_kernel(q, k, v)}): "
              f"kernel {ms:.4f} ms (graph replay), plain {plain:.4f} ms "
              f"({twin_name}), SDPA "
              f"{sdpa:.4f} ms ({note}), bound {b_ms:.4f} ms ({b_by}), max "
              f"abs err {err:.3g} [{gpu}]", flush=True)
        del v
    del q, k, v_raw, mla, frames, cases
    torch.cuda.empty_cache()


def phase18(launches: dict, gpu: str) -> None:
    new_shape_kernels(gpu)
    for arch, depth in FAMILIES_18:
        serve_family(arch, depth, launches, gpu, "18")
    for arch, _ in FAMILIES_18:
        family_card_vs_cpu(arch, "18", CHECK_NEW)


# ---------------------------------------------------------------------------
# Phase 19: LM training
# ---------------------------------------------------------------------------

# A train step on the card against the CPU (float32, TF32 off): the loss
# and the MoE aux loss within LM_TRAIN_LOSS_TOL relative, each gradient leaf
# within LM_TRAIN_GRAD_TOL x its largest magnitude on the CPU.
LM_TRAIN_LOSS_TOL = 1e-4
LM_TRAIN_GRAD_TOL = 1e-3
LM_TRAIN_CHECK_SMOKE = (2, 32)       # batch, sequence of the smoke archs
LM_TRAIN_CHECK_FULL = (2, 128, 2)    # batch, sequence, layers
LM_TRAIN_ARCH = "smollm-135m"
LM_TRAIN_STEPS = 100
LM_TRAIN_WARM = 3                    # steps left out of the median
LM_TRAIN_DATA = (8, 2048)            # batch, sequence
LM_TRAIN_CKPT_EVERY = 50             # a fresh Trainer resumes here ...
LM_TRAIN_REPLAY = 5                  # ... and replays this many steps


def lm_train_grads(params, batch: dict, cfg) -> tuple:
    """(loss, aux, {name: gradient}) of one ``train_loss`` on ``params``'
    device."""
    params.requires_grad_(True)
    dev = params["embed"].device
    loss, metrics = lm.train_loss(
        params, {k: v.to(dev) for k, v in batch.items()}, cfg)
    names, leaves = zip(*params.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return (float(loss.detach()), float(metrics["aux_loss"].detach()),
            {n: g.detach().cpu() for n, g in zip(names, grads)})


def lm_train_card_vs_cpu(cfg, batch_size: int, seq: int) -> str:
    """One ``train_loss`` and every gradient leaf, card against CPU, on
    the same parameters (drawn on the card) and the same batch."""
    card = lm.init_params(torch.Generator(device=DEV).manual_seed(7), cfg,
                          DEV)
    cpu = convert.lm_params_from_numpy(
        {n: p.cpu().numpy() for n, p in card.named_parameters()}, cfg, "cpu")
    batch = lmdata.synthetic_batch(cfg, lmdata.DataConfig(batch_size, seq),
                                   0, device="cpu")
    reset_lm_counts()
    (l_0, a_0, g_0), (l_1, a_1, g_1) = (lm_train_grads(p, batch, cfg)
                                        for p in (cpu, card))
    if any(lm_counts().values()):
        raise AssertionError(f"{cfg.name}: a train step launched an LM "
                             f"kernel: {lm_paths()}")
    errs = {n: float((g_1[n] - g).abs().max())
            / max(float(g.abs().max()), 1e-30) for n, g in g_0.items()}
    worst = max(errs, key=errs.get)
    loss_err = abs(l_1 - l_0) / abs(l_0)
    aux_err = abs(a_1 - a_0) / max(abs(a_0), 1e-30)
    finite = all(torch.isfinite(g).all() for g in g_1.values())
    if not (finite and math.isfinite(l_1) and loss_err <= LM_TRAIN_LOSS_TOL
            and aux_err <= LM_TRAIN_LOSS_TOL
            and errs[worst] <= LM_TRAIN_GRAD_TOL):
        raise AssertionError(f"{cfg.name}: train step, card against CPU: "
                             f"loss {l_1} vs {l_0}, aux {a_1} vs {a_0}, "
                             f"worst leaf {worst} {errs[worst]:.3g}")
    return (f"{cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, batch "
            f"{batch_size} x {seq}): loss {l_0:.6f}, rel err {loss_err:.2g}, "
            f"aux {a_0:.5f} rel err {aux_err:.2g}, {len(errs)} leaves, "
            f"worst {worst} {errs[worst]:.2g} x max|g|")


def lm_train_run(gpu: str, tmp: pathlib.Path) -> None:
    """(b): smollm-135m at full width and depth through ``Trainer``."""
    cfg = get_config(LM_TRAIN_ARCH)                     # bf16, remat, "xla"
    tcfg = lmtrainer.TrainerConfig(steps=LM_TRAIN_STEPS,
                                   ckpt_every=LM_TRAIN_CKPT_EVERY,
                                   ckpt_dir=str(tmp),
                                   log_every=LM_TRAIN_STEPS)
    dcfg = lmdata.DataConfig(*LM_TRAIN_DATA)
    opt = adamw.AdamWConfig(lr=3e-4, warmup_steps=10,
                            total_steps=LM_TRAIN_STEPS)
    trainer = lmtrainer.Trainer(cfg, tcfg, dcfg, opt, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    reset_lm_counts()
    t0 = time.perf_counter()
    hist = trainer.run()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(DEV)
    if any(lm_counts().values()):
        raise AssertionError(f"training launched an LM kernel: {lm_paths()}")
    losses = [h["loss"] for h in hist]
    if len(losses) != LM_TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"training losses: {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first:
        raise AssertionError(f"training did not reduce the loss: {losses}")
    step_s = float(np.median([h["step_time_s"]
                              for h in hist[LM_TRAIN_WARM:]]))
    tokens = LM_TRAIN_DATA[0] * LM_TRAIN_DATA[1]
    print(f"phase 19: {LM_TRAIN_ARCH} training at full width and depth "
          f"({cfg.n_layers} layers, d {cfg.d_model}, {cfg.dtype} compute, "
          f"remat {cfg.remat}, attention {cfg.attention_impl}), batch "
          f"{LM_TRAIN_DATA[0]} x {LM_TRAIN_DATA[1]}, AdamW lr {opt.lr}, "
          f"warm-up {opt.warmup_steps}: {LM_TRAIN_STEPS} steps in "
          f"{wall:.1f} s (checkpoints at {LM_TRAIN_CKPT_EVERY} and "
          f"{LM_TRAIN_STEPS} included), "
          f"{step_s * 1e3:.1f} ms a step (median after {LM_TRAIN_WARM}; min "
          f"{min(h['step_time_s'] for h in hist) * 1e3:.1f}, step 0 "
          f"{hist[0]['step_time_s'] * 1e3:.1f}), {tokens / step_s:.0f} "
          f"tokens/s, peak device memory {peak / 2 ** 30:.2f} GiB; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first 5 "
          f"{first:.4f}, last 5 {last:.4f}), grad norm "
          f"{hist[-1]['grad_norm']:.3f}; no LM kernel launched [{gpu}]",
          flush=True)

    # Resume at step 50 in a fresh Trainer and replay steps 50-54.
    fresh = lmtrainer.Trainer(cfg, tcfg, dcfg, opt, device=DEV)
    if not fresh.try_resume(step=LM_TRAIN_CKPT_EVERY):
        raise AssertionError("no checkpoint at step 50")
    replay = fresh.run(LM_TRAIN_CKPT_EVERY + LM_TRAIN_REPLAY)
    delta = [abs(h["loss"] - losses[h["step"]]) for h in replay]
    if len(delta) != LM_TRAIN_REPLAY or max(delta) > 1e-2:
        raise AssertionError(f"replay of steps 50-54: |dloss| {delta}")
    print(f"phase 19: a fresh Trainer resumed at step {LM_TRAIN_CKPT_EVERY} "
          f"replays steps {LM_TRAIN_CKPT_EVERY}-"
          f"{LM_TRAIN_CKPT_EVERY + LM_TRAIN_REPLAY - 1}: max |dloss| "
          f"{max(delta):.3g} ({sum(d == 0 for d in delta)} of "
          f"{LM_TRAIN_REPLAY} equal bit for bit; checkpoint "
          f"{ckpt_mb(str(tmp), LM_TRAIN_CKPT_EVERY):.0f} MB) [{gpu}]",
          flush=True)
    batch = lmdata.synthetic_batch(cfg, dcfg, LM_TRAIN_STEPS, device=DEV)
    print(f"phase 19: {LM_TRAIN_ARCH} train step: " + device_breakdown(
        lambda: fresh.train_step(fresh.params, fresh.opt_state, batch),
        per=1, unit="train step", ours=("gemm", "softmax", "elementwise"))
        + f" [{gpu}]", flush=True)


def lm_train_refusal(gpu: str) -> None:
    """(c): under ``"pallas"`` a train step raises on the card, before any
    launch; without a gradient the same call launches the kernels."""
    for arch in ("smollm-135m", "zamba2-7b", "rwkv6-7b"):
        cfg = dataclasses.replace(smoke_config(get_config(arch)),
                                  attention_impl="pallas")
        params = lm.init_params(torch.Generator(device=DEV).manual_seed(1),
                                cfg, DEV).requires_grad_(True)
        batch = lmdata.synthetic_batch(cfg, lmdata.DataConfig(2, 64), 0,
                                       device=DEV)
        reset_lm_counts()
        try:
            lm.train_loss(params, batch, cfg)
        except TypeError as e:
            refused = str(e)
        else:
            raise AssertionError(f"{arch}: train_loss under 'pallas' did "
                                 f"not refuse a gradient")
        if any(lm_counts().values()):
            raise AssertionError(f"{arch}: launched before refusing")
        with torch.no_grad():
            loss, _ = lm.train_loss(params, batch, cfg)
        if not (math.isfinite(float(loss)) and any(lm_counts().values())):
            raise AssertionError(f"{arch}: the no-grad call did not launch")
        print(f"phase 19: {arch} (smoke) under 'pallas': with a gradient "
              f"raises ({refused.split(':')[0]}), no launch; under "
              f"no_grad loss {float(loss):.4f} with launches {lm_paths()} "
              f"[{gpu}]", flush=True)


def phase19(launches: dict, gpu: str) -> None:
    import tempfile

    for arch in ARCH_NAMES:
        cfg = dataclasses.replace(smoke_config(get_config(arch)),
                                  dtype="float32")
        print(f"phase 19: card against CPU, "
              f"{lm_train_card_vs_cpu(cfg, *LM_TRAIN_CHECK_SMOKE)} [{gpu}]",
              flush=True)
    batch_size, seq, layers = LM_TRAIN_CHECK_FULL
    cfg = dataclasses.replace(get_config(LM_TRAIN_ARCH), n_layers=layers,
                              dtype="float32")
    print(f"phase 19: card against CPU, "
          f"{lm_train_card_vs_cpu(cfg, batch_size, seq)} [{gpu}]",
          flush=True)
    CKPT_ROOT.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=CKPT_ROOT, prefix="phase19-") as tmp:
        lm_train_run(gpu, pathlib.Path(tmp))
    lm_train_refusal(gpu)


# ---------------------------------------------------------------------------
# Phase 20: the LM shardings
# ---------------------------------------------------------------------------

COMPRESS_ROUNDS, COMPRESS_FRAC = 4, 0.01
SHARD_TURNS = 10                     # DTensor and plain steps, in turns
SHARD_LOSS_TOL = 1e-6                # relative: a 1 x 1 mesh runs the same ops
SHARD_GROUP_MESH = (2, 2)
SHARD_GROUP_DATA = (4, 256, 2)       # batch, sequence, layers
SHARD_GROUP_LOSS_TOL = 1e-4          # relative
SHARD_GROUP_PARAM_TOL = 1e-5         # x max|p| of each leaf
# Where the 4 ranks of (b) run: NCCL takes one card per rank, so ranks
# that share the card are gloo's, and gloo does not carry every collective
# DTensor issues for CUDA tensors: scripts/gloo_cuda_probe.py on the card
# (NVIDIA H100 80GB HBM3, torch 2.11.0+cu128) found all-gather killing a
# rank (SIGSEGV) while reduce-scatter, all-reduce and all-to-all passed.
# So the ranks run on the CPU.
SHARD_GROUP_DEVICE = "cpu"
DRYRUN_CELLS = (("smollm-135m", "train_4k"), ("qwen3-8b", "train_4k"))


def compression_round(grads: dict, states: dict) -> tuple[dict, dict]:
    """One ``compress_with_feedback`` round over every leaf."""
    frames, new = {}, {}
    for name, g in grads.items():
        frames[name], new[name] = compression.compress_with_feedback(
            g, states[name], COMPRESS_FRAC)
    return frames, new


def cpu_compression(name: str, grads: list, noise) -> list:
    """One leaf's rounds and int8 codes on the CPU."""
    state = compression.init_feedback(grads[0])
    out = []
    for g in grads:
        frame, state = compression.compress_with_feedback(g, state,
                                                          COMPRESS_FRAC)
        out.append((frame.indices, frame.values, state.residual))
    return out, compression.quantize_int8(grads[-1], noise=noise)


def phase20_compression(gpu: str) -> None:
    """(a): smollm-135m's gradient leaves, the card against the CPU."""
    from concurrent.futures import ThreadPoolExecutor

    cfg = get_config("smollm-135m")
    shapes = {n: tuple(p.shape) for n, p in
              lm.init_params(None, cfg, "meta").named_parameters()}
    gen = torch.Generator(device=DEV).manual_seed(20)
    rounds = [{n: torch.randn(s, generator=gen, device=DEV)
               for n, s in shapes.items()} for _ in range(COMPRESS_ROUNDS)]
    noise = {n: torch.rand(s, generator=gen, device=DEV) - 0.5
             for n, s in shapes.items()}
    states = {n: compression.init_feedback(g) for n, g in rounds[0].items()}
    card_out, times = {n: [] for n in shapes}, []
    for grads in rounds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames, states = compression_round(grads, states)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        for n in shapes:
            card_out[n].append(tuple(t.cpu() for t in (
                frames[n].indices, frames[n].values, states[n].residual)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes = {n: compression.quantize_int8(rounds[-1][n], noise=noise[n])
             for n in shapes}
    torch.cuda.synchronize()
    q_ms = (time.perf_counter() - t0) * 1e3
    with ThreadPoolExecutor(8) as pool:
        cpu = dict(zip(shapes, pool.map(
            lambda n: cpu_compression(n, [r[n].cpu() for r in rounds],
                                      noise[n].cpu()), shapes)))
    for n in shapes:
        got_rounds, (q, scale) = cpu[n]
        for r, (want, got) in enumerate(zip(card_out[n], got_rounds)):
            for what, w, g in zip(("indices", "values", "residual"), want,
                                  got):
                if not torch.equal(w, g):
                    raise AssertionError(f"compression {n} round {r}: "
                                         f"{what}, card != CPU")
        if not (torch.equal(codes[n][0].cpu(), q)
                and torch.equal(codes[n][1].cpu(), scale)):
            raise AssertionError(f"quantize_int8 {n}: card != CPU")
    numel = sum(math.prod(s) for s in shapes.values())
    sent = sum(max(1, int(COMPRESS_FRAC * math.prod(s)))
               for s in shapes.values())
    print(f"phase 20: compress_with_feedback at frac {COMPRESS_FRAC}, "
          f"{COMPRESS_ROUNDS} rounds over smollm-135m's {len(shapes)} "
          f"gradient leaves ({numel / 1e6:.1f} M entries, the largest "
          f"{max(shapes.values(), key=math.prod)}; {sent} events a round): "
          f"card == CPU bit for bit (indices, values, residuals); ms a "
          f"round {', '.join(f'{t * 1e3:.2f}' for t in times)} (the first "
          f"with warm-up); quantize_int8 with the card's noise: card == CPU "
          f"bit for bit, {q_ms:.2f} ms over the leaves [{gpu}]", flush=True)


class OpTape(torch.utils._python_dispatch.TorchDispatchMode):
    """Each local floating-point op output's name, shape and float64 sum
    (a DTensor's local ops come back through it; DTensor's metadata runs
    on fake tensors are left out)."""

    def __init__(self):
        super().__init__()
        self.rows = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if (isinstance(out, torch.Tensor) and out.is_floating_point()
                and not isinstance(out, FakeTensor) and not func.is_view):
            self.rows.append((str(func), tuple(out.shape),
                              float(out.double().sum())))
        return out


def first_divergent_op(plain, sharded, mesh, batch, cfg) -> str:
    """The first forward op whose output differs between the plain and
    the DTensor ``train_loss`` (one-device mesh: the same local ops)."""
    tapes = []
    for params, scope in ((plain, None), (sharded, mesh)):
        with torch.no_grad(), OpTape() as tape:
            if scope is None:
                lm.train_loss(params, batch, cfg)
            else:
                with sharding.activation_shardings(scope):
                    lm.train_loss(params, {k: sharding.distribute(
                        v, sharding.data_sharding_if_divisible(
                            scope, tuple(v.shape)))
                        for k, v in batch.items()}, cfg)
        tapes.append(tape.rows)
    for i, (a, b) in enumerate(zip(*tapes)):
        if a != b:
            return f"op {i}: plain {a} vs DTensor {b}"
    return f"no forward op differs ({len(tapes[0])} and {len(tapes[1])} ops)"


def one_rank_group():
    """A one-rank gloo group in this process (file rendezvous under
    build/), for a 1 x 1 mesh."""
    import tempfile
    import torch.distributed as dist

    CKPT_ROOT.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=CKPT_ROOT, prefix="phase20-rdv-")
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv", rank=0,
                            world_size=1)
    return tmp


def phase20_train(gpu: str) -> dict:
    """(b), one rank: the DTensor step against the plain one, in turns."""
    import shutil
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import make_debug_mesh

    tmp = one_rank_group()
    try:
        mesh = make_debug_mesh(1, 1, device_type=DEV.type)
        cfg = get_config(LM_TRAIN_ARCH)                 # bf16, remat, "xla"
        dcfg = lmdata.DataConfig(*LM_TRAIN_DATA)
        opt = adamw.AdamWConfig(lr=3e-4, warmup_steps=10,
                                total_steps=SHARD_TURNS)
        plain = lm.init_params(torch.Generator(device=DEV).manual_seed(7),
                               cfg, DEV).requires_grad_(True)
        p_opt = adamw.init(plain)
        dt = lm.init_params(torch.Generator(device=DEV).manual_seed(7), cfg,
                            DEV)
        d_opt = lmtrainer.shard_opt_state(adamw.init(dt), dt, mesh)
        sharding.shard_params(dt, mesh)
        dt.requires_grad_(True)
        steps = {"plain": lmtrainer.make_train_step(cfg, opt, device=DEV),
                 "DTensor": lmtrainer.make_train_step(cfg, opt, mesh=mesh,
                                                      device=DEV)}
        state = {"plain": [plain, p_opt], "DTensor": [dt, d_opt]}
        times, losses = {k: [] for k in steps}, {k: [] for k in steps}
        for i in range(SHARD_TURNS):
            batch = lmdata.synthetic_batch(cfg, dcfg, i, device=DEV)
            order = ("plain", "DTensor") if i % 2 == 0 else ("DTensor",
                                                              "plain")
            for k in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p, o, m = steps[k](*state[k], batch)
                loss = float(m["loss"])
                times[k].append(time.perf_counter() - t0)
                state[k][1] = o
                losses[k].append(loss)
            a, b = losses["plain"][-1], losses["DTensor"][-1]
            if a != b:
                where = first_divergent_op(plain, dt, mesh, batch, cfg)
                print(f"phase 20: step {i}: DTensor loss {b!r} vs plain "
                      f"{a!r}; the first op that differs: {where} [{gpu}]",
                      flush=True)
                if not (math.isfinite(a)
                        and abs(b - a) <= SHARD_LOSS_TOL * abs(a)):
                    raise AssertionError(f"step {i}: the losses differ by "
                                         f"more than {SHARD_LOSS_TOL:g}")
        batch = lmdata.synthetic_batch(cfg, dcfg, SHARD_TURNS, device=DEV)
        with FlopCounterMode(display=False) as fc:
            steps["plain"](*state["plain"], batch)
        flops = fc.get_total_flops()
        tokens = LM_TRAIN_DATA[0] * LM_TRAIN_DATA[1]
        ms = {k: float(np.median(v[1:])) * 1e3 for k, v in times.items()}
        same = sum(x == y for x, y in zip(*losses.values()))
        print(f"phase 20: the sharded train step on a 1 x 1 mesh (DTensor), "
              f"{LM_TRAIN_ARCH} at full width and depth ({cfg.n_layers} "
              f"layers, {cfg.dtype}, remat {cfg.remat}), batch "
              f"{LM_TRAIN_DATA[0]} x {LM_TRAIN_DATA[1]}, {SHARD_TURNS} steps "
              f"in turns with the plain step from the same state: ms a step "
              f"(median of steps 1-{SHARD_TURNS - 1}) DTensor "
              f"{ms['DTensor']:.1f}, plain {ms['plain']:.1f} (ratio "
              f"{ms['DTensor'] / ms['plain']:.3f}); tokens/s DTensor "
              f"{tokens / ms['DTensor'] * 1e3:.0f}, plain "
              f"{tokens / ms['plain'] * 1e3:.0f}; losses "
              f"{losses['plain'][0]:.6f} -> {losses['plain'][-1]:.6f}, "
              f"{same} of {SHARD_TURNS} equal bit for bit, max rel diff "
              f"{max(abs(y - x) / abs(x) for x, y in zip(*losses.values())):.2g}"
              f"; FlopCounterMode count of the plain step {flops:.6e} [{gpu}]",
              flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"flops": flops, "ms": ms}


def phase20_rank(rank: int, world: int, device: str) -> dict:
    """(b), each of 4 gloo ranks: the 2 x 2 sharded step against the
    one-rank step, smollm-135m at full width and 2 layers, float32."""
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(2)
    b, s, layers = SHARD_GROUP_DATA
    cfg = dataclasses.replace(get_config(LM_TRAIN_ARCH), n_layers=layers,
                              dtype="float32")
    dev = torch.device(device)
    mesh = init_device_mesh(device, SHARD_GROUP_MESH,
                            mesh_dim_names=("data", "model"))
    batch = lmdata.synthetic_batch(cfg, lmdata.DataConfig(b, s), 0,
                                   device=dev)
    opt = adamw.AdamWConfig()

    def params():
        return lm.init_params(torch.Generator(device=dev).manual_seed(3),
                              cfg, dev)

    one = params().requires_grad_(True)
    _, _, m1 = lmtrainer.make_train_step(cfg, opt, device=dev)(
        one, adamw.init(one), batch)
    sh = params()
    s_opt = lmtrainer.shard_opt_state(adamw.init(sh), sh, mesh)
    sharding.shard_params(sh, mesh)
    sh.requires_grad_(True)
    t0 = time.perf_counter()
    _, _, m2 = lmtrainer.make_train_step(cfg, opt, mesh=mesh, device=dev)(
        sh, s_opt, batch)
    loss2 = float(m2["loss"])
    step_s = time.perf_counter() - t0
    errs = {}
    for n, p in one.named_parameters():
        got = sharding.full(dict(sh.named_parameters())[n].detach())
        errs[n] = float((got - p.detach()).abs().max()) / max(
            float(p.detach().abs().max()), 1e-30)
    return {"loss": (float(m1["loss"]), loss2), "errs": errs,
            "step_s": step_s}


def phase20_group(gpu: str) -> None:
    from repro_torch.parallel.spawn import run_ranks

    world = math.prod(SHARD_GROUP_MESH)
    t0 = time.perf_counter()
    ranks = run_ranks(phase20_rank, world, SHARD_GROUP_DEVICE,
                      timeout_s=600)
    wall = time.perf_counter() - t0
    for rank, r in enumerate(ranks):
        (l1, l2), errs = r["loss"], r["errs"]
        worst = max(errs, key=errs.get)
        if not (abs(l2 - l1) <= SHARD_GROUP_LOSS_TOL * abs(l1)
                and errs[worst] <= SHARD_GROUP_PARAM_TOL):
            raise AssertionError(f"phase 20 rank {rank}: loss {l2} vs {l1}, "
                                 f"worst leaf {worst} {errs[worst]:.3g}")
    r = ranks[0]
    worst = max(r["errs"], key=r["errs"].get)
    b, s, layers = SHARD_GROUP_DATA
    print(f"phase 20: {world} gloo ranks on a {SHARD_GROUP_MESH[0]} x "
          f"{SHARD_GROUP_MESH[1]} mesh, tensors on the "
          f"{'card' if SHARD_GROUP_DEVICE == 'cuda' else 'CPU'} "
          f"(SHARD_GROUP_DEVICE = {SHARD_GROUP_DEVICE!r}), {LM_TRAIN_ARCH} at "
          f"full width and {layers} layers, float32, batch {b} x {s}: one "
          f"sharded step against the one-rank step: loss {r['loss'][1]:.7f} "
          f"vs {r['loss'][0]:.7f} (rel {abs(r['loss'][1] - r['loss'][0]) / abs(r['loss'][0]):.2g}); "
          f"worst parameter {worst} {r['errs'][worst]:.2g} x max|p| on "
          f"rank 0, every rank within {SHARD_GROUP_PARAM_TOL:g}; sharded "
          f"step {max(x['step_s'] for x in ranks):.2f} s (slowest rank); "
          f"{wall:.1f} s with start-up [{gpu}]", flush=True)


def dryrun_records(args: list) -> tuple[dict, float]:
    """Run ``python -m repro_torch.launch.dryrun`` with ``args`` in a
    process of its own (the fake group owns the default group); its
    records by cell and the wall time."""
    out = CKPT_ROOT / "phase20-dryrun.json"
    CKPT_ROOT.mkdir(exist_ok=True)
    out.unlink(missing_ok=True)
    src = pathlib.Path(__file__).resolve().parent / "src"
    env = {**__import__("os").environ, "PYTHONPATH": str(src)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args, "--no-probes", "--out", str(out)], env=env,
                          capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"dry run {args}: exit {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    recs = json.loads(out.read_text())
    out.unlink()
    return recs, wall


def roofline_row(rec: dict) -> str:
    r = rec["roofline"]
    return (f"{rec['cell']}: compute {r['compute_s'] * 1e3:.3f} ms, memory "
            f"{r['memory_s'] * 1e3:.3f} ms, collective "
            f"{r['collective_s'] * 1e3:.3f} ms, dominant {r['dominant']}, "
            f"bound_s {r['bound_s']:.6g}, useful {r['useful_ratio']:.3f}, "
            f"roofline {r['roofline_fraction']:.4%}; flops/device "
            f"{r['hlo_flops']:.6e}, bytes/device {r['hlo_bytes']:.6e}, "
            f"collective bytes/device {r['coll_bytes']:.6e}, "
            f"{rec['n_ops']} local ops traced; total_live "
            f"{r['bytes_per_device']['total_live'] / 2 ** 30:.2f} GiB")


def phase20_dryrun(gpu: str, train: dict) -> None:
    """(c): the production cells and (b)'s own shape on a 1 x 1 mesh."""
    recs, wall = dryrun_records(
        ["--arch", ",".join(a for a, _ in DRYRUN_CELLS),
         "--shape", ",".join(sorted({s for _, s in DRYRUN_CELLS}))])
    for arch, shape in DRYRUN_CELLS:
        rec = recs[f"{arch}|{shape}|16x16"]
        print(f"phase 20: dry run {roofline_row(rec)}; trace "
              f"{rec['trace_s']} s, cell wall {rec['wall_s']} s [H100 "
              f"roofline constants; {gpu}]", flush=True)
    print(f"phase 20: the dry run of {len(DRYRUN_CELLS)} cells took "
          f"{wall:.1f} s with start-up [{gpu}]", flush=True)
    b, s = LM_TRAIN_DATA
    recs, wall = dryrun_records(
        ["--arch", LM_TRAIN_ARCH, "--shape", "train_4k", "--mesh", "1x1",
         "--batch", str(b), "--seq-len", str(s)])
    rec = recs[f"{LM_TRAIN_ARCH}|train_4k[{b}x{s}]|1x1"]
    flops = rec["roofline"]["hlo_flops"]
    if flops != train["flops"]:
        raise AssertionError(f"dry-run flops {flops} != FlopCounterMode's "
                             f"{train['flops']} on the card")
    bound_ms = rec["roofline"]["bound_s"] * 1e3
    print(f"phase 20: dry run of phase 19's shape {roofline_row(rec)}; "
          f"flops == FlopCounterMode's count of the real step on the card; "
          f"bound {bound_ms:.3f} ms against {train['ms']['plain']:.1f} ms "
          f"a step measured (plain; DTensor {train['ms']['DTensor']:.1f}): "
          f"{bound_ms / train['ms']['plain']:.2%} of it; wall {wall:.1f} s "
          f"[{gpu}]", flush=True)


def phase20(launches: dict, gpu: str) -> None:
    reset_lm_counts()
    t0 = time.perf_counter()
    phase20_compression(gpu)
    t1 = time.perf_counter()
    train = phase20_train(gpu)
    phase20_group(gpu)
    t2 = time.perf_counter()
    phase20_dryrun(gpu, train)
    if any(lm_counts().values()):
        raise AssertionError(f"phase 20 launched an LM kernel: {lm_paths()}")
    print(f"phase 20: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
          f"{time.perf_counter() - t2:.1f} s; no LM kernel launched [{gpu}]",
          flush=True)


# ---------------------------------------------------------------------------
# Phase 21: the example scripts
# ---------------------------------------------------------------------------

EXAMPLES_DIR = pathlib.Path(__file__).resolve().parent / "examples"
# examples/quickstart.py's last line, as the JAX package prints it.
LATENCY_LINE = ("latency budget: 2×MGT hops 300 ns + CDC 135 ns + pack/LUT "
                "72 ns + arb 18 ns + 2×layer-2 380 ns + on-chip 45 ns = 950 "
                "ns chip-to-chip (paper: 0.9–1.3 µs)")
# serve_lm's defaults: 4 prompts of 16 tokens.
SERVE_BATCH, SERVE_PROMPT = 4, 16
# serve_lm's prefill logits through the kernels against the same config's
# plain path (attention_impl "xla") on the card, same parameters and
# prompts, both bf16: within this share of the largest plain logit.
SMOKE_LOGIT_TOL = 2.0 ** -4
SMOKE_LOGIT_REASON = ("bf16 activations: an attention or scan output one "
                      "bf16 ulp apart (the plain scan keeps its decays in "
                      "float32) moves every later rounding over 2 layers")


def load_example(name: str):
    """``examples/<name>_torch.py`` as a module."""
    import importlib.util

    path = EXAMPLES_DIR / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def body_counts() -> dict:
    """The SNN and LM kernels' launches by body since their counts were
    set to 0, those that launched, as ``{"kernel body": n}``."""
    lm_bodies = {f"{k} {b}": n for k, w in (
        ("flash_attention", flash_ops.flash_attention),
        ("linear_scan", scan_ops.linear_scan))
        for b, n in w.launches_by_path.items()}
    return {k: n for k, n in {**snn_paths(), **lm_bodies}.items() if n}


def expect_launches(name: str, counts: dict, want: dict) -> None:
    if counts != want:
        raise AssertionError(f"phase 21: {name}: launches {counts}, "
                             f"expected {want}")


# Each script's check: (module, arguments, what main returned, launches by
# kernel, launches by body) -> the numbers for phase 21's line.  Each
# holds the original script's checks, the launches it must make, and
# (quickstart, serve_lm) the kernels on what the script gave them against
# their plain versions; multichip_snn's event == dense is that check.

def quickstart_check(mod, args, out, counts, paths) -> str:
    expect_launches("quickstart", counts, {"exchange": 1})  # one route_step
    if out["dropped"] != [0] * 4 or out["spikes"] <= 0 \
            or len(set(out["received"])) != 1:
        raise AssertionError(f"quickstart: {out}")
    if out["latency_line"] != LATENCY_LINE:
        raise AssertionError(f"quickstart: {out['latency_line']!r}")
    # The same chip run again, then its spikes routed through the exchange
    # kernel and through the unfused plain composition.
    cfg, params, stimulus = mod.inputs(DEV)
    spikes, last = mod.emulate_chip(params, stimulus, cfg)
    (fused, f_drops), (plain, p_drops) = (
        mod.route_spikes(last, use_fused=f) for f in (True, False))
    torch.cuda.synchronize()
    for field, a, b in zip(("labels", "times", "valid", "drops"),
                           (*fused, f_drops), (*plain, p_drops)):
        if not torch.equal(a, b):
            raise AssertionError(f"quickstart: the exchange kernel's {field} "
                                 f"differ from use_fused=False's")
    if spikes != out["spikes"] or fused.count().tolist() != out["received"]:
        raise AssertionError(f"quickstart again: {spikes} spikes, received "
                             f"{fused.count().tolist()}; first run {out}")
    return (f"{out['spikes']} output spikes over 50 steps, received "
            f"{out['received']}, dropped {out['dropped']}; run again, the "
            f"exchange kernel's ingress frames and drops == use_fused=False's"
            f" bit for bit")


def multichip_snn_check(mod, args, out, counts, paths) -> str:
    # Two event streams and two per-step loops of T steps; the dense run,
    # Fig 5 and training launch nothing.
    expect_launches("multichip_snn", counts,
                    {"exchange": 4 * mod.config().n_steps})
    if not (out["event_equals_dense"] and out["stream_equals_loop"]):
        raise AssertionError(f"multichip_snn: {out}")
    if not np.isfinite(out["loss"]).all():
        raise AssertionError(f"multichip_snn: losses {out['loss']}")
    fig5 = ", ".join(f"{f['rate_hz'] / 1e6:.1f} MHz median "
                     f"{f['median_ns']:.0f} / p99 {f['p99_ns']:.0f} ns"
                     for f in out["fig5"])
    return (f"event == dense {out['event_equals_dense']}, stream == loop "
            f"{out['stream_equals_loop']}, drops {out['drops']}, 32 steps "
            f"{out['loop_ms']:.1f} ms loop against {out['stream_ms']:.1f} "
            f"ms streamed; Fig 5: {fig5}; {len(out['loss'])} train steps "
            f"in {out['train_s']:.2f} s, loss {out['loss'][0]:.4f} → "
            f"{out['loss'][-1]:.4f}")


def serve_lm_check(mod, args, out, counts, paths) -> str:
    arch = args[1]
    cfg = mod.config(arch, True)
    scan = cfg.family == "ssm"
    # generate's warm pass and the timed one: two prefills; decode runs no
    # kernel.
    expect_launches(arch, counts, {"linear_scan" if scan
                                   else "flash_attention": 2 * cfg.n_layers})
    if out["launches"] != paths:
        raise AssertionError(f"serve_lm {arch} printed launches "
                             f"{out['launches']}, the wrappers counted "
                             f"{paths}")
    toks = np.array(out["tokens"])
    if toks.shape != (SERVE_BATCH, 24) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"serve_lm {arch}: tokens {toks.shape}")
    params, prompts = mod.inputs(cfg, SERVE_BATCH, SERVE_PROMPT, DEV)
    with torch.no_grad():
        got, want = (lm.prefill(params, {"tokens": prompts}, c)[0]
                     for c in (cfg, dataclasses.replace(
                         cfg, attention_impl="xla")))
    torch.cuda.synchronize()
    err = check_close(f"serve_lm {arch} smoke prefill logits, kernels vs "
                      f"plain", got, want, 0.0,
                      SMOKE_LOGIT_TOL * float(want.abs().max()),
                      SMOKE_LOGIT_REASON, "21")
    # The kernel alone at the smoke prefill's shape, as phases 2 and 17.
    gen = torch.Generator(device=DEV).manual_seed(21)
    h, d = cfg.n_heads, cfg.head_dim_
    b, s = SERVE_BATCH, SERVE_PROMPT
    if scan:
        k_err = scan_check(f"{arch} smoke prefill: b{b} h{h} t{s} k{d} v{d} "
                           f"bf16 bonus",
                           rwkv_inputs(gen, b, h, s, d, torch.bfloat16,
                                       views=True),
                           "bonus", "channel_decay",
                           (BF16_ULP, 1e-3, SCAN_TC_REASON), "21")
    else:
        hkv = cfg.n_kv_heads
        k_err = flash_check(f"{arch} smoke prefill: b{b} h{h}/{hkv} s{s} "
                            f"d{d} bf16 causal",
                            *flash_inputs(gen, b, h, hkv, s, d,
                                          torch.bfloat16, True),
                            True, "decode", "21")
    return (f"{arch} smoke config ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, head_dim {d}, vocab {cfg.vocab_size}; batch "
            f"{b} x {s} + 24): prefill {out['prefill_ms']:.2f} ms, decode "
            f"{out['decode_ms']:.1f} ms, {out['tokens_per_s']:.1f} tok/s; "
            f"prefill logits vs the plain path max abs err {err:.3g}, the "
            f"kernel at this shape {k_err:.3g}")


def train_lm_check(mod, args, out, counts, paths) -> str:
    expect_launches("train_lm", counts, {})          # training: no kernel
    if out["resumed_at"] != 100 or not out["last"] < out["first"]:
        raise AssertionError(f"train_lm: resumed at {out['resumed_at']}, "
                             f"loss {out['first']} → {out['last']}")
    return (f"{out['n_params'] / 1e6:.1f}M params, {len(out['losses'])} "
            f"steps, resumed at step {out['resumed_at']}, loss (mean of 5) "
            f"{out['first']:.4f} → {out['last']:.4f}")


# (script, arguments, its check); each runs on the card by default.
EXAMPLE_RUNS = (("quickstart", [], quickstart_check),
                ("multichip_snn", [], multichip_snn_check),
                ("serve_lm", ["--arch", "qwen3-8b"], serve_lm_check),
                ("serve_lm", ["--arch", "rwkv6-7b"], serve_lm_check),
                ("train_lm", ["--simulate-failure"], train_lm_check))


def phase21(launches: dict, gpu: str) -> None:
    import tempfile

    CKPT_ROOT.mkdir(exist_ok=True)
    for name, args, verify in EXAMPLE_RUNS:
        mod = load_example(name)
        with tempfile.TemporaryDirectory(dir=CKPT_ROOT,
                                         prefix="phase21-") as tmp:
            kw = {"ckpt_dir": tmp} if name == "train_lm" else {}
            torch.cuda.synchronize()
            reset_snn_counts()
            reset_lm_counts()
            before = other_launches()
            t0 = time.perf_counter()
            out = mod.main(args, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = {"merge_pack": ops.fused_merge_pack.launches,
                  "exchange": ops.fused_exchange.launches, **lm_counts(),
                  **{k: n - before[k] for k, n in other_launches().items()}}
        counts = {k: n for k, n in counts.items() if n}
        paths = body_counts()
        for k, n in counts.items():
            launches[k] += n
        count_lm_bodies(launches)
        summary = verify(mod, args, out, counts, paths)
        cmd = " ".join([f"examples/{name}_torch.py", *args])
        print(f"phase 21: {cmd}: wall {wall:.2f} s, launches by body "
              f"{paths or 'none'}; {summary} [{gpu}]", flush=True)
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
        usage = ptxas_usage(log.read_text()) if log.exists() else []
        print(f"phase 1: {stem}: {'; '.join(usage) or 'cached build'}",
              flush=True)

    results: dict = {}
    launches = {k: 0 for k in KERNEL_SOURCES}
    healthy: dict = {}

    def timed_phase(name: str, fn) -> None:
        t_start = time.perf_counter()
        fn()
        print(f"phase {name}: wall time {time.perf_counter() - t_start:.1f} "
              f"s", flush=True)

    timed_phase("2", lambda: (phase2(results), phase2_interconnect(results),
                              phase2_stdp(results), phase2_lm(results)))
    timed_phase("3", lambda: healthy.update(phase3(launches, gpu)))
    timed_phase("4", phase4)
    timed_phase("5", lambda: phase5(launches, gpu))
    timed_phase("6", phase6)
    timed_phase("7", lambda: phase7(launches, gpu))
    timed_phase("8", lambda: phase8(launches, gpu))
    timed_phase("9", lambda: phase9(launches, gpu, healthy))
    timed_phase("10", lambda: phase10(launches, gpu, healthy))
    timed_phase("11", lambda: phase11(gpu))
    # stdp_slot's main-path launches: those of phases 12-13's per-slot runs.
    stdp_ops.stdp_slot.launches = 0
    timed_phase("12", lambda: phase12(launches, gpu))
    timed_phase("13", lambda: phase13(launches, gpu))
    launches["stdp_slot"] += stdp_ops.stdp_slot.launches
    timed_phase("14", lambda: phase14(launches, gpu))
    timed_phase("15", lambda: phase15(launches, gpu))
    timed_phase("16", lambda: phase16(launches, gpu))
    timed_phase("17", lambda: phase17(launches, gpu))
    timed_phase("18", lambda: phase18(launches, gpu))
    timed_phase("19", lambda: phase19(launches, gpu))
    timed_phase("20", lambda: phase20(launches, gpu))
    timed_phase("21", lambda: phase21(launches, gpu))

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
    # The scan's main-path launches by body (phases 5 and 17); its two
    # tensor-core bodies both serve a main path.
    bodies = {b: launches.get(f"linear_scan {b}", 0)
              for b in scan_ops.linear_scan.launches_by_path}
    next(e for e in kernels if e["name"] == "linear_scan").update(
        bodies=bodies, sources=SCAN_SOURCES)
    for body in ("scalar_decay", "channel_decay"):
        if not bodies[body]:
            raise AssertionError(f"linear_scan's {body} body never launched "
                                 f"on the main path")
    # flash_attention's: wgmma on every prefill (phases 5, 17, 18), decode
    # on whisper's decode steps (phase 18: 24 a step, 792 in all) and
    # serve_lm's smoke prefills (phase 21).
    bodies = {b: launches.get(f"flash_attention {b}", 0)
              for b in flash_ops.flash_attention.launches_by_path}
    next(e for e in kernels if e["name"] == "flash_attention").update(
        bodies=bodies)
    for body in ("wgmma", "decode"):
        if not bodies[body]:
            raise AssertionError(f"flash_attention's {body} body never "
                                 f"launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
