"""Training launcher (port of ``src/repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --smoke --device cpu --steps 200 --batch-size 8 --seq-len 128

trains a reduced config on the CPU; without ``--device`` it trains on the
card.  The flags are the JAX package's, plus ``--device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    cfg = dataclasses.replace(cfg, remat=False) if args.smoke else cfg

    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir)
    dcfg = DataConfig(batch_size=args.batch_size, seq_len=args.seq_len)
    opt = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                            warmup_steps=max(10, args.steps // 20))

    trainer = Trainer(cfg, tcfg, dcfg, opt, device=args.device)
    if args.resume and trainer.try_resume():
        print(f"resumed from step {trainer.step}")
    history = trainer.run()
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(history, f, indent=1)
    first = sum(h["loss"] for h in history[:5]) / max(len(history[:5]), 1)
    last = sum(h["loss"] for h in history[-5:]) / max(len(history[-5:]), 1)
    print(f"loss: first-5 avg {first:.4f} → last-5 avg {last:.4f}")
    return history


if __name__ == "__main__":
    main()
