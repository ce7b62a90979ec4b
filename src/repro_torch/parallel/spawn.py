"""Run one function on every rank of a process group on one host.

``run_ranks(fn, world, *args)`` starts ``world`` processes with the
``spawn`` method (safe in a parent that already holds a CUDA context),
joins them in one gloo process group through a ``file://`` rendezvous in a
temporary directory (no fixed port, so several groups can run at once),
calls ``fn(rank, world, *args)`` on each and returns the ranks' results
in rank order.  ``fn`` and its arguments are pickled, so ``fn`` must be a
module-level function its module can import in a fresh interpreter.

A rank that raises fails the call with its traceback; a group that
outlasts ``timeout_s`` is terminated and fails it too.  The process
group's own timeout is the same, so a collective waiting on a dead peer
raises in the survivors instead of hanging.
"""

from __future__ import annotations

import datetime
import multiprocessing
import pathlib
import pickle
import tempfile
import time
import traceback
from multiprocessing.connection import wait


def _rank_main(rank: int, world: int, timeout_s: float, tmp: str) -> None:
    import torch.distributed as dist

    out = pathlib.Path(tmp) / f"rank{rank}"
    try:
        fn, args = pickle.loads((pathlib.Path(tmp) / "call.pkl").read_bytes())
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.with_suffix(".pkl").write_bytes(pickle.dumps(result))
    except BaseException:
        out.with_suffix(".err").write_text(traceback.format_exc())
        raise


def run_ranks(fn, world: int, *args, timeout_s: float = 300.0) -> list:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    computed in its own process of one gloo process group."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        # The call goes through a file, not the processes' arguments: the
        # parent writes those into each child's pipe and would wait on
        # every child's start-up in turn once they outgrow its buffer.
        (pathlib.Path(tmp) / "call.pkl").write_bytes(pickle.dumps((fn, args)))
        procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                             args=(r, world, timeout_s, tmp))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        pending = {p.sentinel: p for p in procs}
        try:
            # Wait for every rank, but stop at the first failure: its peers
            # may block in a collective on it until the group times out.
            while pending and time.monotonic() < deadline:
                for s in wait(list(pending), deadline - time.monotonic()):
                    pending.pop(s).join()
                if any(p.exitcode for p in procs):
                    break
        finally:
            hung = [p.name for p in procs if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join()
        failed = {r: p.exitcode for r, p in enumerate(procs)
                  if p.exitcode and p.name not in hung}
        if hung and not failed:
            raise TimeoutError(f"ranks {hung} of {world} still ran after "
                               f"{timeout_s} s")
        if failed:
            errs = [pathlib.Path(tmp) / f"rank{r}.err" for r in failed]
            detail = "\n".join(e.read_text() for e in errs if e.exists())
            raise RuntimeError(f"ranks failed with exit codes {failed}:\n"
                               f"{detail}")
        return [pickle.loads((pathlib.Path(tmp) / f"rank{r}.pkl")
                             .read_bytes()) for r in range(world)]
