"""Deterministic synthetic data pipeline (port of
``src/repro/data/pipeline.py``): prefetched and resumable.

Batches are a pure function of (seed, step), drawn with the same numpy
generator calls as the JAX package's, so both packages give the same
tokens, embeddings and labels bit for bit, and a restarted run consumes the
same data from its checkpointed step.

The synthetic LM stream is an order-2 structured sequence (tokens depend on
two predecessors through a fixed random mixing table) so models have real
signal to fit — loss decreasing below the unigram entropy proves learning.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0
    prefetch: int = 2


def _mixing_table(vocab: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(257,), dtype=np.int64)


def synthetic_batch(cfg: ModelConfig, dcfg: DataConfig, step: int,
                    device=None) -> dict:
    """Order-2 synthetic token batch: t_i = T[(a·t_{i-1} + b·t_{i-2}) % 257]
    ⊕ noise.  Deterministic in (seed, step).

    Returns ``{"tokens": int32 [B, S+1]}``; for an embeddings-input arch
    float32 ``embeds`` [B, S, D] with the decoder's ``tokens`` [B, S+1]
    (encoder-decoder) or ``labels`` int32 [B, S].  Tensors on ``device``
    (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    rng = np.random.default_rng(dcfg.seed * 1_000_003 + step)
    b, s = dcfg.batch_size, dcfg.seq_len
    table = _mixing_table(cfg.vocab_size, dcfg.seed)
    toks = np.empty((b, s + 1), np.int64)
    toks[:, 0] = rng.integers(0, cfg.vocab_size, b)
    toks[:, 1] = rng.integers(0, cfg.vocab_size, b)
    noise = rng.random((b, s + 1)) < 0.1
    for i in range(2, s + 1):
        det = table[(3 * toks[:, i - 1] + 5 * toks[:, i - 2]) % 257] \
            % cfg.vocab_size
        rnd = rng.integers(0, cfg.vocab_size, b)
        toks[:, i] = np.where(noise[:, i], rnd, det)
    tokens = torch.from_numpy(toks.astype(np.int32)).to(device)

    if cfg.input_mode == "embeddings":
        embeds = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        embeds = torch.from_numpy(embeds).to(device)
        if cfg.encoder_layers:
            return {"embeds": embeds, "tokens": tokens}
        return {"embeds": embeds, "labels": tokens[:, 1:]}
    return {"tokens": tokens}


class Pipeline:
    """Background-prefetching iterator with explicit step state.

    A worker thread draws batches on the host, ``prefetch`` ahead;
    ``__next__`` moves one to ``device`` (the card unless the caller asks
    for the CPU), applies ``shard_fn`` and returns ``(step, batch)``.
    ``close`` stops the worker."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig, start_step: int = 0,
                 shard_fn=None, device=None):
        self.cfg, self.dcfg = cfg, dcfg
        self.device = resolve_device(device)
        self.step = start_step
        self.shard_fn = shard_fn or (lambda x: x)
        self._q: queue.Queue = queue.Queue(maxsize=dcfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = synthetic_batch(self.cfg, self.dcfg, step, device="cpu")
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        batch = {k: v.to(self.device) for k, v in batch.items()}
        return step, self.shard_fn(batch)

    def close(self):
        """Stop the worker and wait for it (it wakes at least every 0.5 s)."""
        self._stop.set()
        self._thread.join(5.0)
