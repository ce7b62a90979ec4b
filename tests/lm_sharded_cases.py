"""Cases of the LM sharding parity tests (``test_torch_lm_sharding.py``).

The port's rank body (torch only: run by ``parallel.spawn.run_ranks`` in
one gloo group of 8 ranks on a 2 x 4 ``("data", "model")`` mesh) and the
reference's oracle (JAX only: the same mesh of 8 host devices, run by
``jax_oracle`` in its own interpreter, which must set ``XLA_FLAGS`` before
JAX starts).  Both take their inputs from ``make_inputs``: numpy arrays
from a seed, and the reference's ``init_params`` weights, which the oracle
draws itself from the same key and the port receives flattened.  Not a
test module: pytest does not collect it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile

import numpy as np

N_RANKS = 8
MESH = (2, 4)
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
KEY = 3
# grok-1's smoke config at capacity factor 1: frames overflow, and a frame
# per data shard (expert_capacity(32) = 8 slots) drops other events than
# one frame for all 64 tokens (16 slots).
GROK = dict(moe_local_dispatch=True, capacity_factor=1.0)
TRAIN_STEPS = 3
# Gradient and serving cases beside qwen3-8b's step: heads that miss the
# 4-way model axis (attention splits the sequence there, and the decode
# caches their sequence), the two scans (per head, RWKV6's bonus u a
# per-head parameter) and MLA.
GRAD_CASES = {"qwen3-8b, 2 heads": ("qwen3-8b", dict(n_heads=2,
                                                      n_kv_heads=1)),
              "rwkv6-7b": ("rwkv6-7b", {}), "zamba2-7b": ("zamba2-7b", {}),
              "deepseek-v2-236b": ("deepseek-v2-236b", {})}


def smoke(pkg, arch: str, **overrides):
    """The float32 ``"xla"`` smoke config of ``arch`` from ``pkg``'s
    ``configs`` module (``repro.configs`` or ``repro_torch.configs``)."""
    return dataclasses.replace(pkg.smoke_config(pkg.get_config(arch)),
                               dtype="float32", attention_impl="xla",
                               **overrides)


def make_inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return dict(qwen_tokens=rng.integers(1, 256, (4, 17)).astype(np.int32),
                grok_tokens=rng.integers(1, 256, (4, 17)).astype(np.int32),
                grok_x=rng.normal(size=(4, 16, 64)).astype(np.float32))


# ---------------------------------------------------------------------------
# The port's ranks
# ---------------------------------------------------------------------------


def _port_params(arrays: dict, cfg):
    """The port's parameters from copies of ``arrays`` (``convert`` shares
    a CPU tensor's memory with its array, and a step writes in place)."""
    from repro_torch import convert

    return convert.lm_params_from_numpy(
        {k: v.copy() for k, v in arrays.items()}, cfg, "cpu")


def _step_case(mesh, inp: dict, qwen: dict) -> dict:
    """qwen3-8b: the sharded loss, its gradients and one full step
    (gradients and AdamW, the default schedule) against the single-device
    ones from the same parameters."""
    import torch

    import repro_torch.configs as tc
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as S
    from repro_torch.runtime.trainer import make_train_step, shard_opt_state

    cfg = smoke(tc, "qwen3-8b")
    batch = {"tokens": torch.from_numpy(inp["qwen_tokens"])}
    opt_cfg = adamw.AdamWConfig()
    plain = _port_params(qwen, cfg).requires_grad_(True)
    loss = M.train_loss(plain, batch, cfg)[0]
    base_loss = float(loss)
    names, leaves = zip(*plain.named_parameters())
    p_grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    p_opt = adamw.init(plain)
    _, _, p_metrics = make_train_step(cfg, opt_cfg, device="cpu")(
        plain, p_opt, batch)

    sharded = _port_params(qwen, cfg)
    s_opt = shard_opt_state(adamw.init(sharded), sharded, mesh)
    S.shard_params(sharded, mesh)
    placements = {n: tuple(p.placements)
                  for n, p in sharded.named_parameters()}
    tok = S.distribute(batch["tokens"], S.data_sharding_if_divisible(
        mesh, tuple(batch["tokens"].shape)))
    sharded.requires_grad_(True)
    with S.activation_shardings(mesh):
        loss = M.train_loss(sharded, {"tokens": tok}, cfg)[0]
        grads = torch.autograd.grad(loss, [p for _, p in
                                           sharded.named_parameters()])
        loss = S.full(loss)
    grad_errs = {n: float((S.full(g) - p_grads[n]).abs().max())
                 / max(float(p_grads[n].abs().max()), 1e-30)
                 for n, g in zip(names, grads)}
    _, s_opt, s_metrics = make_train_step(cfg, opt_cfg, mesh=mesh,
                                          device="cpu")(sharded, s_opt, batch)
    got = {n: S.full(p.detach()) for n, p in sharded.named_parameters()}
    errs = {n: float((got[n] - p.detach()).abs().max())
            / max(float(p.detach().abs().max()), 1e-30)
            for n, p in plain.named_parameters()}
    want_pl = {n: tuple(s.placements)
               for n, s in S.param_shardings(plain, mesh).items()}
    return dict(base_loss=base_loss, sharded_loss=float(loss),
                step_loss=(float(p_metrics["loss"]),
                           float(s_metrics["loss"])),
                grad_norm=(float(p_metrics["grad_norm"]),
                           float(s_metrics["grad_norm"])),
                param_errs=errs, grad_errs=grad_errs, placements_ok=placements == want_pl,
                moments_ok=all(tuple(s_opt.m[n].placements) == want_pl[n]
                               for n in want_pl),
                moved=any(float((got[n] - p).abs().max()) > 0
                          for n, p in _port_params(qwen, cfg)
                          .named_parameters()))


def _grad_case(mesh, arch: str, overrides: dict, tokens) -> dict:
    """One config's sharded loss and gradients against one device's, from
    the same parameters (the port's init from a seed)."""
    import torch

    import repro_torch.configs as tc
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as S

    cfg = smoke(tc, arch, **overrides)
    batch = {"tokens": torch.from_numpy(tokens)}

    def grads(params, batch):
        params.requires_grad_(True)
        loss = M.train_loss(params, batch, cfg)[0]
        names, leaves = zip(*params.named_parameters())
        return loss, dict(zip(names, torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)))

    def params():
        return M.init_params(torch.Generator().manual_seed(2), cfg, "cpu")

    loss1, g1 = grads(params(), batch)
    sharded = S.shard_params(params(), mesh)
    tok = S.distribute(batch["tokens"], S.data_sharding_if_divisible(
        mesh, tuple(batch["tokens"].shape)))
    with S.activation_shardings(mesh):
        loss2, g2 = grads(sharded, {"tokens": tok})
    errs = {n: float((S.full(g2[n]) - g).abs().max())
            / max(float(g.abs().max()), 1e-30) for n, g in g1.items()}
    return dict(loss=(float(loss1), float(S.full(loss2))), grad_errs=errs)


def _serve_case(mesh, arch: str, overrides: dict, tokens) -> dict:
    """A sharded prefill, and a decode step into caches laid out by
    ``cache_shardings`` (K/V split on the sequence where the heads miss
    the model axis), against one device's: the largest differences of the
    prefill logits, the decode logits and the caches after the step."""
    import torch

    import repro_torch.configs as tc
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as S

    cfg = smoke(tc, arch, **overrides)
    tokens = torch.from_numpy(tokens[:, :12])
    b, index = tokens.shape[0], 3

    def params():
        return M.init_params(torch.Generator().manual_seed(2), cfg, "cpu")

    def leaves(tree):
        out = []
        S.map_tree(lambda t: out.append(S.full(t)) or t, tree)
        return out

    one = params()
    logits1, _, _ = M.prefill(one, {"tokens": tokens}, cfg)
    caches1 = M.init_cache(cfg, b, 16, device="cpu")
    step1, _ = M.decode_step(one, tokens[:, -1], caches1, index, cfg)
    sharded = S.shard_params(params(), mesh)
    caches2 = S.map_tree(lambda t: S.distribute(
        t, S.cache_shardings(cfg, mesh, t)), M.init_cache(cfg, b, 16,
                                                          device="cpu"))
    tok = S.distribute(tokens, S.data_sharding_if_divisible(
        mesh, tuple(tokens.shape)))
    with S.activation_shardings(mesh):
        logits2, _, _ = M.prefill(sharded, {"tokens": tok}, cfg)
        step2, _ = M.decode_step(sharded, tok[:, -1], caches2, index, cfg)
    return dict(
        prefill=float((S.full(logits2) - logits1).abs().max()),
        decode=float((S.full(step2) - step1).abs().max()),
        caches=max(float((a - w).abs().max())
                   for a, w in zip(leaves(caches2), leaves(caches1))))


def _moe_case(mesh, inp: dict, grok: dict) -> dict:
    """grok-1-314b with ``moe_local_dispatch``: the sharded loss, and one
    MoE layer's output and ``dropped_frac`` on the mesh and on one
    device."""
    import torch

    import repro_torch.configs as tc
    from repro_torch.models import model as M
    from repro_torch.models.moe import moe_forward
    from repro_torch.parallel import sharding as S

    cfg = smoke(tc, "grok-1-314b", **GROK)
    params = _port_params(grok, cfg)
    x = torch.from_numpy(inp["grok_x"])
    y1, m1 = moe_forward(params["moe"].per_layer()[0]["moe"], x, cfg)
    S.shard_params(params, mesh)
    tok = S.distribute(torch.from_numpy(inp["grok_tokens"]),
                       S.data_sharding_if_divisible(mesh, (4, 17)))
    xs = S.distribute(x, S.data_sharding_if_divisible(mesh, (4, 16, 64)))
    with S.activation_shardings(mesh):
        loss = S.full(M.train_loss(params, {"tokens": tok}, cfg)[0])
        y, m = moe_forward(params["moe"].per_layer()[0]["moe"], xs, cfg)
    return dict(loss=float(loss), dropped=float(S.full(m["dropped_frac"])),
                y=S.full(y).numpy(), dropped_one=float(m1["dropped_frac"]),
                y_one=y1.numpy())


def _trainer_case(mesh, tmp: str, rank: int) -> dict:
    """``Trainer(mesh=)`` against ``Trainer()`` for ``TRAIN_STEPS`` steps;
    then a one-device ``Trainer`` resumes the sharded one's checkpoint."""
    import torch

    import repro_torch.configs as tc
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as S
    from repro_torch.runtime import trainer as T

    cfg = smoke(tc, "qwen3-8b")

    def trainer(ckpt_dir, mesh):
        return T.Trainer(cfg, T.TrainerConfig(steps=TRAIN_STEPS,
                                              ckpt_every=100,
                                              ckpt_dir=ckpt_dir,
                                              log_every=1000),
                         DataConfig(4, 16, 2),
                         adamw.AdamWConfig(warmup_steps=1,
                                           total_steps=TRAIN_STEPS),
                         mesh=mesh, device="cpu")

    sharded = trainer(os.path.join(tmp, "sharded"), mesh)
    s_hist = sharded.run()
    plain = trainer(os.path.join(tmp, f"plain{rank}"), None)
    p_hist = plain.run()
    whole = {n: S.full(p.detach()) for n, p in sharded.params.named_parameters()}
    other = trainer(os.path.join(tmp, "sharded"), None)
    resumed = other.try_resume()
    same = resumed and all(torch.equal(whole[n], p.detach())
                           for n, p in other.params.named_parameters())
    return dict(sharded=[h["loss"] for h in s_hist],
                plain=[h["loss"] for h in p_hist],
                resumed_step=other.step, resumed_equal=bool(same))


def _resume_case(mesh, directory: str) -> dict:
    """``resume_on_mesh`` of an unsharded smollm-135m checkpoint."""
    import torch

    import repro_torch.configs as tc
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as S
    from repro_torch.runtime import trainer as T
    from repro_torch.runtime.elastic import resume_on_mesh

    cfg = smoke(tc, "smollm-135m")
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    like = {"params": params, "opt": adamw.init(params)}
    state, manifest = resume_on_mesh(directory, like, mesh)
    tree, _ = ckpt.restore(directory, {
        "params": T.nested(adamw.named(params)),
        "opt": adamw.AdamWState(step=like["opt"].step,
                                m=T.nested(like["opt"].m),
                                v=T.nested(like["opt"].v))}, device="cpu")
    want = {"params": T.flat(tree["params"]), "m": T.flat(tree["opt"].m),
            "v": T.flat(tree["opt"].v)}
    got = {"params": state["params"], "m": state["opt"].m,
           "v": state["opt"].v}
    pl = {n: tuple(s.placements)
          for n, s in S.param_shardings(params, mesh).items()}
    return dict(
        step=manifest["step"], opt_step=int(S.full(state["opt"].step)),
        step_placements=tuple(state["opt"].step.placements),
        equal=all(torch.equal(S.full(got[k][n]), want[k][n])
                  for k in got for n in want[k]),
        placements_ok=all(tuple(got[k][n].placements) == pl[n]
                          for k in got for n in pl),
        n_leaves=sum(len(v) for v in got.values()),
        sharded=sum(any(type(x).__name__ == "Shard"
                        for x in got["params"][n].placements) for n in pl))


def port_rank(rank: int, world: int, inp: dict, qwen: dict, grok: dict,
              tmp: str, ckpts: dict) -> dict:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
    out = dict(step=_step_case(mesh, inp, qwen),
               grads={k: _grad_case(mesh, a, o, inp["qwen_tokens"])
                      for k, (a, o) in GRAD_CASES.items()},
               serve={k: _serve_case(mesh, a, o, inp["qwen_tokens"])
                      for k, (a, o) in GRAD_CASES.items()},
               moe=_moe_case(mesh, inp, grok),
               trainer=_trainer_case(mesh, tmp, rank),
               resume={k: _resume_case(mesh, d) for k, d in ckpts.items()})
    return out if rank == 0 else {"resume": out["resume"]}


# ---------------------------------------------------------------------------
# The reference's oracle
# ---------------------------------------------------------------------------


def _jax_oracle(inp: dict) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import repro.configs as jc
    from repro import compat
    from repro.models import model as JM
    from repro.models.layers import Param, is_param
    from repro.models.moe import moe_forward
    from repro.parallel import sharding as shardlib

    cfg = smoke(jc, "grok-1-314b", **GROK)
    params = JM.init_params(jax.random.key(KEY), cfg)
    mesh = compat.make_mesh(MESH, ("data", "model"))
    params_s = jax.device_put(params, shardlib.param_shardings(params, mesh))
    tok = jax.device_put(jnp.asarray(inp["grok_tokens"]),
                         NamedSharding(mesh, P("data", None)))
    layer0 = jax.tree.map(lambda p: Param(p.value[0], p.axes[1:]),
                          params["moe"]["moe"], is_leaf=is_param)
    layer0_s = jax.device_put(layer0, shardlib.param_shardings(layer0, mesh))
    x = jax.device_put(jnp.asarray(inp["grok_x"]),
                       NamedSharding(mesh, P("data", None, None)))
    with mesh, shardlib.activation_shardings(mesh):
        loss, _ = jax.jit(lambda p, t: JM.train_loss(p, {"tokens": t}, cfg))(
            params_s, tok)
        y, m = jax.jit(lambda p, x: moe_forward(p, x, cfg))(layer0_s, x)
    return dict(loss=float(loss), dropped=float(m["dropped_frac"]),
                y=np.asarray(y))


def jax_oracle_main(in_path: str, out_path: str) -> None:
    inp = pickle.loads(pathlib.Path(in_path).read_bytes())
    pathlib.Path(out_path).write_bytes(pickle.dumps(_jax_oracle(inp)))


@contextlib.contextmanager
def jax_oracle(inputs: dict):
    """Start the reference's 8-device oracle in its own interpreter; the
    context yields a function that waits for and returns its results (so
    the port's ranks can run meanwhile)."""
    with tempfile.TemporaryDirectory(prefix="lm_oracle_") as tmp:
        src, dst = pathlib.Path(tmp, "in.pkl"), pathlib.Path(tmp, "out.pkl")
        src.write_bytes(pickle.dumps(inputs))
        prog = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "import lm_sharded_cases; "
                "lm_sharded_cases.jax_oracle_main(*sys.argv[2:])")
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
               "PYTHONPATH": os.pathsep.join(
                   [str(SRC), os.environ.get("PYTHONPATH", "")])}
        proc = subprocess.Popen(
            [sys.executable, "-c", prog, str(pathlib.Path(__file__).parent),
             str(src), str(dst)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

        def result() -> dict:
            _, err = proc.communicate(timeout=600)
            if proc.returncode:
                raise RuntimeError(f"the JAX oracle failed:\n{err[-3000:]}")
            return pickle.loads(dst.read_bytes())

        try:
            yield result
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
