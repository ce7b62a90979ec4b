"""Serving launcher: batched prefill + decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --smoke --device cpu

runs a reduced config on the CPU; without ``--device`` it runs on the card,
through the flash-attention and linear-scan kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import model as M


@dataclasses.dataclass
class ServeStats:
    prefill_s: float
    decode_s: float
    tokens: int

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.decode_s if self.decode_s else 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(cfg, params, prompts: torch.Tensor, max_new: int,
             max_len: int | None = None, greedy: bool = True,
             temperature: float = 1.0, key: torch.Generator | None = None,
             warm: bool = True):
    """Batched generation.  prompts: int[B, S], on the parameters' device.

    ``greedy=True`` (default) picks the argmax at every step —
    deterministic.  ``greedy=False`` samples from the temperature-scaled
    softmax with the generator ``key`` (default: seed 0 on the prompts'
    device); a generator in the same state reproduces the same sequences.
    ``temperature <= 0`` is the zero-entropy limit and selects greedily.

    ``warm=True`` (default) drives prefill, the cache splice and one
    decode step once on the real shapes before the clocks start, so
    ``ServeStats`` times steady-state execution, not the first call's
    set-up (the kernels' build, library handles, allocator growth).  The
    warm pass leaves ``key``'s state as it found it.
    """
    b, s = prompts.shape
    device = prompts.device
    max_len = max_len or (s + max_new)
    greedy = greedy or temperature <= 0.0
    if not greedy and key is None:
        key = torch.Generator(device=device).manual_seed(0)

    def select(logits):
        if greedy:
            return torch.argmax(logits, -1).to(torch.int32)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=key)[:, 0].to(
            torch.int32)

    if warm:
        key_state = None if greedy else key.get_state()
        w_logits, w_caches, _ = M.prefill(params, {"tokens": prompts}, cfg)
        w_dec = _splice_prefill(cfg, M.init_cache(cfg, b, max_len, device),
                                w_caches, s)
        w_logits2, _ = M.decode_step(params, select(w_logits), w_dec, s, cfg)
        select(w_logits2)
        _sync(device)
        if key_state is not None:
            key.set_state(key_state)
        del w_logits, w_caches, w_dec, w_logits2

    t0 = time.perf_counter()
    logits, caches, _ = M.prefill(params, {"tokens": prompts}, cfg)
    # Move prefill caches into the fixed-size decode cache.
    dec_caches = _splice_prefill(cfg, M.init_cache(cfg, b, max_len, device),
                                 caches, s)
    del caches
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out_tokens = []
    tok = select(logits)
    t0 = time.perf_counter()
    for i in range(max_new):
        out_tokens.append(tok)
        logits, dec_caches = M.decode_step(params, tok, dec_caches, s + i, cfg)
        tok = select(logits)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return (torch.stack(out_tokens, 1),
            ServeStats(prefill_s=t_prefill, decode_s=t_decode,
                       tokens=b * max_new))


def _tree_map(fn, *trees):
    """Map over the tensors of matching NamedTuple / tuple / dict trees."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    items = [_tree_map(fn, *parts) for parts in zip(*trees, strict=True)]
    return type(first)(*items) if hasattr(first, "_fields") \
        else type(first)(items)


def _splice_prefill(cfg, dec_caches, pre_caches, s):
    """Copy prefill K/V (length s) into the zero-initialized decode cache.

    Recurrent state leaves (SSM/conv) carry no sequence dim — prefill's
    final state *is* the decode state (equal shapes, pass through).  Every
    sequence-carrying layout ``model.init_cache`` builds keeps the sequence
    on the second-to-last axis — KV ``[L, B, H, S, Dh]``, MLA latent
    ``[L, B, S, rank]`` — so the splice axis is ``ndim - 2`` by
    construction.  It must NOT be sniffed from dim sizes: a prompt length
    that collides with ``n_heads``/``head_dim`` would match the wrong axis
    first.  The decode cache is written in place and returned.
    """
    def splice(dst, src):
        if src.shape == dst.shape:
            return src.to(dst.dtype)
        axis = dst.dim() - 2
        if (dst.dim() == src.dim() and src.shape[axis] == s
                and dst.shape[axis] >= s
                and all(a == b for i, (a, b) in
                        enumerate(zip(src.shape, dst.shape)) if i != axis)):
            dst.narrow(axis, 0, s).copy_(src)
            return dst
        raise ValueError(f"cannot splice cache {tuple(src.shape)} into "
                         f"{tuple(dst.shape)} (prompt length {s}, expected "
                         f"the sequence on axis {axis})")
    return _tree_map(splice, dec_caches, pre_caches)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--sample", action="store_true",
                    help="sample instead of greedy argmax")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    # The hand-written kernels: launched on the card, their plain versions
    # on the CPU.
    cfg = dataclasses.replace(get_config(args.arch), attention_impl="pallas")
    if args.smoke:
        cfg = smoke_config(cfg)
    params = M.init_params(torch.Generator(device=device).manual_seed(0), cfg,
                           device)
    prompts = torch.randint(1, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator(device=device)
                            .manual_seed(1), device=device)
    tokens, stats = generate(cfg, params, prompts, args.max_new,
                             greedy=not args.sample,
                             temperature=args.temperature,
                             key=torch.Generator(device=device)
                             .manual_seed(args.seed))
    print(f"generated {tuple(tokens.shape)} tokens on {device}")
    print(f"prefill {stats.prefill_s*1e3:.0f} ms, decode "
          f"{stats.decode_s*1e3:.0f} ms, {stats.tokens_per_s:.1f} tok/s")


if __name__ == "__main__":
    main()
