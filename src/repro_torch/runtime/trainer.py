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
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime.watchdog import StepWatchdog, WatchdogConfig

NO_MESH = ("the LM shardings (parallel/sharding.py's param_shardings and "
           "the sharded train step) are not ported yet (ROADMAP.md queue 1, "
           "item 10): train on one device, mesh=None")


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
    ``requires_grad``.  A ``mesh`` raises: the sharded step is still to
    port."""
    if mesh is not None:
        raise NotImplementedError(NO_MESH)
    device = resolve_device(device)

    def train_step(params, opt_state, batch):
        named = adamw.named(params)
        for p in named.values():
            p.requires_grad_(True)
        batch = {k: v.to(device) for k, v in batch.items()}
        loss, metrics = M.train_loss(params, batch, cfg)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True, materialize_grads=True)
        params, opt_state, opt_metrics = adamw.update(
            params, dict(zip(named, grads)), opt_state, opt_cfg)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def _nested(flat: dict) -> dict:
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


def _flat(tree: dict, prefix: str = "") -> dict:
    """``_nested``'s inverse."""
    out = {}
    for key, sub in tree.items():
        if isinstance(sub, dict):
            out.update(_flat(sub, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = sub[0]
    return out


class Trainer:
    """``tcfg.steps`` train steps of ``cfg`` on synthetic batches, with
    checkpoints every ``ckpt_every`` steps and restarts from the latest.
    Parameters from ``init_params`` with a generator seeded by
    ``tcfg.seed`` on ``device`` (the card unless the caller asks for the
    CPU)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 dcfg: DataConfig | None = None,
                 opt_cfg: adamw.AdamWConfig | None = None, mesh=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(NO_MESH)
        self.cfg = cfg
        self.tcfg = tcfg
        self.dcfg = dcfg or DataConfig()
        self.opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=tcfg.steps)
        self.device = resolve_device(device)
        self.restarts = 0

        gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        self.params = M.init_params(gen, cfg, self.device)
        self.params.requires_grad_(True)
        self.opt_state = adamw.init(self.params)
        self.step = 0
        self.train_step = make_train_step(cfg, self.opt_cfg,
                                          device=self.device)
        self.history: list[dict] = []

    # -- checkpointing --------------------------------------------------------
    def _state_tree(self):
        s = self.opt_state
        return {"params": _nested(adamw.named(self.params)),
                "opt": adamw.AdamWState(step=s.step, m=_nested(s.m),
                                        v=_nested(s.v))}

    def save(self):
        ckpt.save(self.tcfg.ckpt_dir, self.step, self._state_tree(),
                  metadata={"model": self.cfg.name, "data_step": self.step})
        ckpt.prune(self.tcfg.ckpt_dir, self.tcfg.keep_ckpts)

    def try_resume(self, step: int | None = None) -> bool:
        """Restore the newest verified checkpoint, or ``step``'s; False if
        there is none.  The parameters are written in place."""
        if step is None:
            step = ckpt.latest_step(self.tcfg.ckpt_dir)
            if step is None:
                return False
        tree, manifest = ckpt.restore(self.tcfg.ckpt_dir, self._state_tree(),
                                      step, device=self.device)
        restored = _flat(tree["params"])
        with torch.no_grad():
            for name, p in adamw.named(self.params).items():
                p.copy_(restored[name])
        opt = tree["opt"]
        self.opt_state = adamw.AdamWState(step=opt.step, m=_flat(opt.m),
                                          v=_flat(opt.v))
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
