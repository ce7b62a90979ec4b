"""Fault-tolerant LM training loop (port of ``src/repro/runtime/trainer.py``):
checkpoint/restart, watchdog, determinism.

Recovery model:
  * every N steps: atomic checkpoint (params, optimizer state, data step);
  * a failed step (``RuntimeError``, ``FloatingPointError``) restores the
    latest checkpoint, up to ``max_restarts`` times;
  * the data pipeline is a pure function of (seed, step) → a restart
    replays the same batches.

The checkpoint tree is the JAX package's ``{"params": ..., "opt":
AdamWState(step, m, v)}`` with its leaf names (``params_layers_attn_wq_0``,
``opt_.m_embed_0``, ``opt_.step``), so a checkpoint that either package's
``Trainer`` writes restores in the other's.  The step runs where the
parameters live: the card unless the caller asks for the CPU.

On a device mesh (``mesh=``, a ``DeviceMesh`` over every rank of the
default process group) the step is the JAX package's sharded one, on
DTensors: parameters and AdamW moments laid out by ``param_shardings``,
the step count replicated and the batch by ``data_sharding_if_divisible``
(``launch/dryrun.py``'s layout), the loss under ``activation_shardings``.
Checkpoints stay mesh-agnostic: every rank gathers the full tensors and
rank 0 alone writes them, in the same format, so either package restores
them on any mesh or on one device (``runtime.elastic.resume_on_mesh``).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shardlib
from repro_torch.runtime.watchdog import StepWatchdog, WatchdogConfig


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep_ckpts: int = 3
    log_every: int = 10
    max_restarts: int = 3
    seed: int = 0


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    mesh=None, device=None):
    """The train step ``(params, opt_state, batch) → (params, opt_state,
    metrics)``: ``train_loss``, its gradient for every parameter by
    ``torch.autograd`` (zero for one the loss does not read) and
    ``adamw.update``, which writes the parameters and the optimizer state
    in place.  The batch moves to ``device`` (the card unless the caller
    asks for the CPU); the parameters must be there and get
    ``requires_grad``.

    With a ``mesh`` (``check_mesh``; its device type must be ``device``'s)
    the parameters and moments are DTensors laid out as ``shard_params``
    and ``shard_opt_state`` lay them out, and each batch tensor, which
    every rank holds whole, is sharded on its batch dimension; each
    gradient is reduced to its parameter's layout before the update, and
    the metrics come back whole on every rank."""
    device = resolve_device(device)
    if mesh is not None:
        _check_mesh_device(mesh, device)

    def train_step(params, opt_state, batch):
        named = adamw.named(params)
        for p in named.values():
            p.requires_grad_(True)
        if mesh is None:
            batch = {k: v.to(device) for k, v in batch.items()}
            loss, metrics = M.train_loss(params, batch, cfg)
            grads = torch.autograd.grad(loss, list(named.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
            params, opt_state, opt_metrics = adamw.update(
                params, dict(zip(named, grads)), opt_state, opt_cfg)
        else:
            batch = {k: _shard_batch(v, mesh, device)
                     for k, v in batch.items()}
            with shardlib.activation_shardings(mesh):
                loss, metrics = M.train_loss(params, batch, cfg)
                grads = torch.autograd.grad(loss, list(named.values()),
                                            allow_unused=True,
                                            materialize_grads=True)
                # The FSDP reduce-scatter: each gradient (partial sums on
                # the data axes) to its parameter's layout.
                grads = [g.redistribute(p.device_mesh, p.placements)
                         for g, p in zip(grads, named.values())]
                params, opt_state, opt_metrics = adamw.update(
                    params, dict(zip(named, grads)), opt_state, opt_cfg)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return params, opt_state, {k: shardlib.full(v.detach())
                                   for k, v in metrics.items()}

    return train_step


def _check_mesh_device(mesh, device: torch.device) -> None:
    """The mesh must span the group and share the step's device type (or
    the step runs on ``meta`` tensors: a dry run)."""
    shardlib.check_mesh(mesh)
    if device.type not in (mesh.device_type, "meta"):
        raise ValueError(f"a {mesh.device_type!r} mesh for a step on "
                         f"{device}: the mesh's device type must be the "
                         "step's")


def _shard_batch(v, mesh, device):
    """A batch tensor, which every rank holds whole, sharded on its batch
    dimension (a DTensor stays as it is)."""
    from torch.distributed.tensor import DTensor

    if isinstance(v, DTensor):
        return v
    return shardlib.distribute(
        v.to(device), shardlib.data_sharding_if_divisible(mesh,
                                                          tuple(v.shape)))


def shard_opt_state(opt_state: adamw.AdamWState, params,
                    mesh) -> adamw.AdamWState:
    """AdamW state on ``mesh``: the step replicated, ``m`` and ``v`` laid
    out as their parameters by ``param_shardings``.  Every rank must hold
    the same whole state (nothing moves)."""
    shard = shardlib.param_shardings(params, mesh)

    def put(tree):
        return {n: shardlib.distribute(t, shard[n])
                for n, t in tree.items()}

    return adamw.AdamWState(
        step=shardlib.distribute(opt_state.step, shardlib.replicated(mesh)),
        m=put(opt_state.m), v=put(opt_state.v))


def nested(flat: dict) -> dict:
    """``{dotted name: tensor}`` as the JAX package's parameter tree: nested
    dicts, each tensor in a one-item list where its ``Param`` holds it (so
    its leaf name ends in ``_0``)."""
    tree: dict = {}
    for name, t in flat.items():
        *path, last = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = [t]
    return tree


def flat(tree: dict, prefix: str = "") -> dict:
    """``nested``'s inverse."""
    out = {}
    for key, sub in tree.items():
        if isinstance(sub, dict):
            out.update(flat(sub, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = sub[0]
    return out


class Trainer:
    """``tcfg.steps`` train steps of ``cfg`` on synthetic batches, with
    checkpoints every ``ckpt_every`` steps and restarts from the latest.
    Parameters from ``init_params`` with a generator seeded by
    ``tcfg.seed`` on ``device`` (the card unless the caller asks for the
    CPU); with a ``mesh`` every rank draws them whole and keeps its pieces
    (``shard_params``), and the step is ``make_train_step``'s sharded
    one."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 dcfg: DataConfig | None = None,
                 opt_cfg: adamw.AdamWConfig | None = None, mesh=None,
                 device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.dcfg = dcfg or DataConfig()
        self.opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=tcfg.steps)
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            _check_mesh_device(mesh, self.device)
        self.restarts = 0

        gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        self.params = M.init_params(gen, cfg, self.device)
        self.opt_state = adamw.init(self.params)
        if mesh is not None:
            self.opt_state = shard_opt_state(self.opt_state, self.params,
                                             mesh)
            shardlib.shard_params(self.params, mesh)
        self.params.requires_grad_(True)
        self.step = 0
        self.train_step = make_train_step(cfg, self.opt_cfg, mesh=mesh,
                                          device=self.device)
        self.history: list[dict] = []

    # -- checkpointing --------------------------------------------------------
    def _state_tree(self):
        """The checkpoint tree; on a mesh of whole tensors (a collective
        every rank takes part in)."""
        s = self.opt_state
        whole = {n: shardlib.full(p.detach())
                 for n, p in adamw.named(self.params).items()}
        return {"params": nested(whole),
                "opt": adamw.AdamWState(
                    step=shardlib.full(s.step),
                    m=nested({n: shardlib.full(t) for n, t in s.m.items()}),
                    v=nested({n: shardlib.full(t) for n, t in s.v.items()}))}

    def save(self):
        tree = self._state_tree()
        if self.mesh is None or dist.get_rank() == 0:
            ckpt.save(self.tcfg.ckpt_dir, self.step, tree,
                      metadata={"model": self.cfg.name,
                                "data_step": self.step})
            ckpt.prune(self.tcfg.ckpt_dir, self.tcfg.keep_ckpts)
        if self.mesh is not None:
            dist.barrier()

    def try_resume(self, step: int | None = None) -> bool:
        """Restore the newest verified checkpoint, or ``step``'s; False if
        there is none.  The parameters are written in place."""
        if step is None:
            step = ckpt.latest_step(self.tcfg.ckpt_dir)
            if step is None:
                return False
        if self.mesh is not None:
            from repro_torch.runtime.elastic import resume_on_mesh

            state, manifest = resume_on_mesh(
                self.tcfg.ckpt_dir, {"params": self.params,
                                     "opt": self.opt_state}, self.mesh,
                step=step)
            restored, self.opt_state = state["params"], state["opt"]
        else:
            tree, manifest = ckpt.restore(self.tcfg.ckpt_dir,
                                          self._state_tree(), step,
                                          device=self.device)
            restored = flat(tree["params"])
            opt = tree["opt"]
            self.opt_state = adamw.AdamWState(step=opt.step, m=flat(opt.m),
                                              v=flat(opt.v))
        with torch.no_grad():
            for name, p in adamw.named(self.params).items():
                p.copy_(restored[name])
        self.step = manifest["metadata"]["data_step"]
        return True

    # -- the loop -------------------------------------------------------------
    def run(self, steps: int | None = None) -> list[dict]:
        steps = steps or self.tcfg.steps
        watchdog = StepWatchdog(WatchdogConfig())
        while self.step < steps:
            try:
                t0 = time.monotonic()
                batch = synthetic_batch(self.cfg, self.dcfg, self.step,
                                        device=self.device)
                with watchdog:
                    self.params, self.opt_state, metrics = self.train_step(
                        self.params, self.opt_state, batch)
                    # One copy to the host, which waits for the step.
                    values = torch.stack([v.to(torch.float32) for v in
                                          metrics.values()]).tolist()
                metrics = dict(zip(metrics, values))
                metrics["step"] = self.step
                metrics["step_time_s"] = time.monotonic() - t0
                self.history.append(metrics)
                if self.step % self.tcfg.log_every == 0:
                    print(f"step {self.step:5d}  loss {metrics['loss']:.4f}  "
                          f"gnorm {metrics['grad_norm']:.3f}  "
                          f"{metrics['step_time_s']*1e3:.0f} ms")
                self.step += 1
                if self.step % self.tcfg.ckpt_every == 0:
                    self.save()
            except (RuntimeError, FloatingPointError) as e:
                # Failure → restore-latest recovery path.
                self.restarts += 1
                if self.restarts > self.tcfg.max_restarts:
                    raise
                print(f"step {self.step} failed ({e}); restoring latest "
                      f"checkpoint (restart {self.restarts})")
                if not self.try_resume():
                    raise
        self.save()
        return self.history
