"""End-to-end training on the PyTorch/CUDA port: train the ~135M-parameter
smollm-135m for a few hundred steps on the synthetic order-2 LM task, with
checkpoint/restart (``examples/train_lm.py`` with ``repro_torch``).

Full-size config (the real 135M model) at reduced sequence length; loss
must drop well below the unigram entropy.  A mid-run simulated failure
exercises the restore-latest path: a second ``Trainer`` resumes from the
newest checkpoint and carries the loss curve on.

Training launches no hand-written kernel: it runs under
``attention_impl="xla"``, as the JAX package trains, and the port's
flash-attention and linear-scan wrappers refuse a call that needs a
gradient.

  PYTHONPATH=src python examples/train_lm_torch.py --steps 200
  PYTHONPATH=src python examples/train_lm_torch.py --steps 200 --smoke \\
      --device cpu                                    # fast CI

Checkpoints go to ``repro_torch_train_lm_ckpt`` under the temporary
directory (``main(ckpt_dir=...)`` moves them), which is emptied first.
The weights come from a ``torch.Generator`` seeded 0, so the losses differ
from the JAX script's.
"""

import argparse
import dataclasses
import math
import os
import shutil
import tempfile

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig

CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm_ckpt")


def train(cfg, tcfg: TrainerConfig, dcfg: DataConfig,
          opt: adamw.AdamWConfig, simulate_failure: bool, device) -> dict:
    """Train ``cfg`` for ``tcfg.steps`` steps, with a kill and resume at
    half way if ``simulate_failure``; returns the parameter count, the
    resume step (or None) and the loss of every step."""
    trainer = Trainer(cfg, tcfg, dcfg, opt, device=device)
    n_params = sum(p.numel() for p in trainer.params.parameters())
    print(f"training {cfg.name}: {n_params/1e6:.0f}M params, "
          f"{tcfg.steps} steps, batch {dcfg.batch_size}×{dcfg.seq_len}")

    resumed_at = None
    if simulate_failure:
        half = tcfg.steps // 2
        pre_history = trainer.run(steps=half)
        print(f"--- simulating node failure at step {half}: discarding live "
              "state, resuming from latest checkpoint ---")
        trainer2 = Trainer(cfg, tcfg, dcfg, opt, device=device)
        if not trainer2.try_resume():
            raise AssertionError("no checkpoint found")
        resumed_at = trainer2.step
        print(f"resumed at step {resumed_at}")
        trainer2.history = list(pre_history)   # keep the full loss curve
        trainer = trainer2
    history = trainer.run()

    first = sum(h["loss"] for h in history[:5]) / 5
    last = sum(h["loss"] for h in history[-5:]) / 5
    print(f"\nloss: {first:.3f} → {last:.3f} "
          f"(uniform baseline {math.log(cfg.vocab_size):.3f})")
    if not last < first:
        raise AssertionError("training did not reduce loss")
    return {"n_params": n_params, "resumed_at": resumed_at,
            "losses": [h["loss"] for h in history], "first": first,
            "last": last}


def main(argv=None, *, ckpt_dir: str = CKPT) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (fast CI path)")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--simulate-failure", action="store_true",
                    help="kill and resume mid-run to exercise recovery")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("smollm-135m")
    if args.smoke:
        cfg = smoke_config(cfg)
    cfg = dataclasses.replace(cfg, remat=False)

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=max(args.steps // 4, 10),
                         ckpt_dir=str(ckpt_dir),
                         log_every=max(args.steps // 10, 1))
    dcfg = DataConfig(batch_size=args.batch_size, seq_len=args.seq_len)
    opt = adamw.AdamWConfig(lr=1e-3, total_steps=args.steps,
                            warmup_steps=max(args.steps // 10, 5))
    return train(cfg, tcfg, dcfg, opt, args.simulate_failure, args.device)


if __name__ == "__main__":
    main()
