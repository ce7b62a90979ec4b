"""Serve a small model with batched requests on the PyTorch/CUDA port:
prefill + KV-cache decode (``examples/serve_lm.py`` with ``repro_torch``).

Demonstrates the serving path the dry run models at production shapes
(decode_32k / long_500k), at smoke scale, including cache splicing from
prefill into the fixed-size decode cache.  The config runs under
``attention_impl="pallas"``, as ``repro_torch.launch.serve`` does, so that
on the card the prefill launches the hand-written kernels: flash attention
(qwen3-8b: its ``wgmma`` body for bf16 operands) or the linear scan
(rwkv6-7b, zamba2-7b).  Decode runs no kernel.  The script prints the
launches by kernel body (the warm-up prefill of ``generate`` included).

  PYTHONPATH=src python examples/serve_lm_torch.py --arch qwen3-8b --smoke
  PYTHONPATH=src python examples/serve_lm_torch.py --arch rwkv6-7b --smoke
  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

``--smoke`` is on whatever the command line says, as in the JAX script,
so the smoke config is always served.  Weights and prompts come from
``torch.Generator``s seeded 0 and 1 as that script's keys, so the tokens
differ from its tokens.
"""

import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.launch.serve import generate
from repro_torch.models import model as M

KERNELS = {"flash_attention": flash_ops.flash_attention,
           "linear_scan": scan_ops.linear_scan}


def launches_by_body() -> dict:
    """The LM kernels' launch counts by body, ``{"kernel body": n}``."""
    return {f"{name} {body}": n for name, wrapper in KERNELS.items()
            for body, n in wrapper.launches_by_path.items()}


def serve(cfg, params, prompts: torch.Tensor, max_new: int) -> dict:
    """``generate`` greedily from ``prompts`` int[B, S]; prints the
    script's three lines and returns the tokens, the times and the kernel
    launches by body that the call made."""
    before = launches_by_body()
    tokens, stats = generate(cfg, params, prompts, max_new)
    launched = {k: n - before[k] for k, n in launches_by_body().items()
                if n > before[k]}
    batch = prompts.shape[0]
    print(f"{cfg.name}: {batch} requests × {max_new} new tokens")
    print(f"prefill {stats.prefill_s*1e3:.0f} ms | decode "
          f"{stats.decode_s*1e3:.0f} ms | {stats.tokens_per_s:.1f} tok/s")
    print("first request's tokens:", tokens[0].tolist())
    print(f"kernel launches by body: {launched or 'none'}")
    return {"arch": cfg.name, "tokens": tokens.tolist(),
            "prefill_ms": stats.prefill_s * 1e3,
            "decode_ms": stats.decode_s * 1e3,
            "tokens_per_s": stats.tokens_per_s, "launches": launched}


def config(arch: str, smoke: bool):
    """The served config: the JAX script's, under ``"pallas"``."""
    cfg = smoke_config(get_config(arch)) if smoke else get_config(arch)
    if cfg.input_mode == "embeddings":
        raise SystemExit("pick a token-input arch for this demo")
    return dataclasses.replace(cfg, attention_impl="pallas")


def inputs(cfg, batch: int, prompt_len: int, device: torch.device):
    """The parameters and the prompts int[batch, prompt_len] in
    ``[1, vocab)``, drawn as ``main`` draws them."""
    params = M.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg, device)
    prompts = torch.randint(1, cfg.vocab_size, (batch, prompt_len),
                            generator=torch.Generator(device=device)
                            .manual_seed(1), device=device)
    return params, prompts


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = config(args.arch, args.smoke)
    params, prompts = inputs(cfg, args.batch, args.prompt_len,
                             resolve_device(args.device))
    return serve(cfg, params, prompts, args.max_new)


if __name__ == "__main__":
    main()
