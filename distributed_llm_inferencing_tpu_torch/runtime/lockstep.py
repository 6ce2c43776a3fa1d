"""Lockstep execution of one engine over a tp group of processes.

The port's counterpart of the JAX package's ``runtime/multihost.py``
(``LockstepExecutor``): every rank launches the same ops in the same
order, so the collectives inside each forward pair up. The process that
serves (the worker, rank 0) is the leader. It spawns ``tp - 1`` follower
processes (a ``spawn`` context: CUDA state does not survive a fork),
which join the group (parallel/mesh.py ``TPGroup``), then loop on the ops
the leader broadcasts over the control group:

- ``load``: build the rank's engine (runtime/engine.py) from the leader's
  arguments; every rank reports whether it succeeded;
- ``generate`` / ``teacher_forced``: run the rank's side of the request.
  The leader resolves the seed and validates the request before it
  broadcasts; it alone samples and broadcasts each token (the engine's
  ``_sample``), so every rank runs the same number of steps;
- ``stats`` / ``reset_counts``: each rank's kernel launch counts and
  collective counts, gathered on the leader, or zeroed;
- ``stop``: leave the loop and exit.

Failure is loud. A follower that fails to load makes the load fail; one
that fails in a request prints its traceback and exits, so the leader's
next collective raises and the request fails; the leader then marks the
group broken and every later op raises. A follower whose leader is gone
exits on its own (its parent is watched). ``stop`` joins every follower
with a timeout and raises if one had to be killed.
"""

from __future__ import annotations

import multiprocessing
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback

import torch

from distributed_llm_inferencing_tpu_torch.ops import (
    flash_attention, fused_decode, paged_attention, quant_matmul)
from distributed_llm_inferencing_tpu_torch.parallel.mesh import TPGroup

# ops whose ranks report back (error or payload) on the control group
REPLY_OPS = ("load", "stats", "reset_counts")
STOP_TIMEOUT_S = 60.0

# every kernel wrapper (each counts its launches), by kernel name
KERNELS = {
    "flash_attention": flash_attention.flash_attention,
    "flash_decode": flash_attention.flash_decode,
    "paged_flash_decode": paged_attention.paged_flash_decode,
    "fused_decode_step": fused_decode.fused_decode_step,
    "q4_matmul": quant_matmul.q4_matmul,
    "q4_matmul_row": quant_matmul.q4_matmul_row,
}


# the wrappers with a tensor-core form, which count its launches apart
MMA_FORMS = ("flash_attention", "q4_matmul", "q4_matmul_row")


def launch_counts() -> dict:
    """This process's kernel launches, by kernel, and each wrapper's
    tensor-core launches among them as "<kernel>[mma]"."""
    counts = {k: fn.launches for k, fn in KERNELS.items()}
    for k in MMA_FORMS:
        counts[f"{k}[mma]"] = KERNELS[k].launches_mma
    return counts


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0
    for k in MMA_FORMS:
        KERNELS[k].launches_mma = 0


class Leader:
    """Rank 0's side: the followers' processes and the group."""

    def __init__(self, world: int, device: torch.device):
        if device.type == "cuda":
            # build every kernel once, before two ranks could race nvcc
            from distributed_llm_inferencing_tpu_torch.ops import build
            build.build_all()
        self._dir = tempfile.mkdtemp(prefix="dli-tp-")
        store = os.path.join(self._dir, "store")
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(
            target=follower_main, daemon=True, name=f"dli-tp-rank{r}",
            args=(r, world, str(device), store, os.getpid()))
            for r in range(1, world)]
        self.broken = None
        for p in self.procs:
            p.start()
        try:
            self.group = TPGroup(0, world, device, store,
                                 alive=self._check_alive)
        except BaseException:
            self._reap(force=True)
            raise

    def _check_alive(self):
        dead = [f"rank {r + 1} (exit code {p.exitcode})"
                for r, p in enumerate(self.procs) if not p.is_alive()]
        if dead:
            raise RuntimeError(f"tp follower exited: {', '.join(dead)}")

    def run(self, op: str, kw: dict, local):
        """Broadcast ``op`` to the followers and run ``local()`` here.
        For a reply op, returns every rank's payload in rank order (the
        leader's first); raises if any rank failed. Otherwise returns
        ``local()``'s result."""
        if self.broken:
            raise RuntimeError(f"tp group is broken: {self.broken}")
        try:
            self._check_alive()
            self.group.broadcast_object((op, kw))
            if op not in REPLY_OPS:
                return local()
            try:
                mine = (None, local())
            except Exception as e:
                mine = (f"rank 0: {type(e).__name__}: {e}", None)
            replies = self.group.gather_objects(mine)
        except BaseException as e:
            self.broken = f"{op}: {type(e).__name__}: {e}"
            self._reap(force=True)
            raise
        errors = [err for err, _ in replies if err]
        if errors:
            raise RuntimeError(f"tp {op} failed: {'; '.join(errors)}")
        return [payload for _, payload in replies]

    def stop(self):
        """Stop and join every follower; raises if one had to be
        killed."""
        if not self.broken:
            try:
                self.group.broadcast_object(("stop", {}))
            except Exception as e:   # a follower already gone
                self.broken = f"stop: {type(e).__name__}: {e}"
            else:
                self.group.close()   # as each follower does on "stop"
        self.broken = self.broken or "stopped"
        self._reap(force=False)

    def _reap(self, force: bool):
        killed = []
        deadline = time.monotonic() + (0 if force else STOP_TIMEOUT_S)
        for r, p in enumerate(self.procs, start=1):
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(10)
                killed.append(r)
        shutil.rmtree(self._dir, ignore_errors=True)
        if killed and not force:
            raise RuntimeError(f"tp followers {killed} did not stop within "
                               f"{STOP_TIMEOUT_S:.0f} s and were killed")

    def alive(self) -> list:
        return [p.pid for p in self.procs if p.is_alive()]


def _watch_leader(leader_pid: int):
    """Exit when the leader is gone (this process is re-parented)."""
    def watch():
        while os.getppid() == leader_pid:
            time.sleep(1.0)
        os._exit(3)
    threading.Thread(target=watch, daemon=True, name="leader-watch").start()


def follower_main(rank: int, world: int, device: str, store: str,
                  leader_pid: int):
    """A follower's process: join the group, then serve the leader's ops
    until ``stop``."""
    from distributed_llm_inferencing_tpu_torch.runtime.engine import (
        InferenceEngine)
    _watch_leader(leader_pid)
    group = TPGroup(rank, world, torch.device(device), store)
    engine = None
    while True:
        op, kw = group.broadcast_object()
        if op == "stop":
            break
        try:
            if op == "load":
                engine = InferenceEngine(**kw, group=group)
                out = None
            else:
                out = getattr(engine, "_" + op)(**kw)
            err = None
        except Exception as e:
            if op not in REPLY_OPS:   # the leader's collective fails next
                traceback.print_exc()
                sys.stderr.flush()
                os._exit(1)
            err, out = f"rank {rank}: {type(e).__name__}: {e}", None
        if op in REPLY_OPS:
            group.gather_objects((err, out))
    group.close()
