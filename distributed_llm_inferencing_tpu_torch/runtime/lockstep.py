"""Lockstep execution of one engine or batcher over a group of processes.

The port's counterpart of the JAX package's ``runtime/multihost.py``
(``LockstepExecutor``): every rank launches the same ops in the same
order, so the collectives and hops inside each forward pair up. The
process that serves (the worker, rank 0) is the leader. It spawns
``pp·sp·tp·ep - 1`` follower processes (a ``spawn`` context: CUDA state
does not survive a fork), each on the leader's count of intra-op threads
(torch's default is one per core, so a group of four beside a leader on
one thread would otherwise run three followers of a thread per core),
which join the group (parallel/mesh.py ``TPGroup``), then loop on the
ops the leader broadcasts over the control group:

- ``load``: build the rank's engine (runtime/engine.py) from the leader's
  arguments, after laying the group out as the mesh's grid
  (``TPGroup.configure``: the tp, expert, sp and pp subgroups of this
  load);
  every rank reports whether it succeeded;
- ``generate`` / ``teacher_forced``, and a speculative request's
  ``spec_prefill`` / ``spec_plain`` / ``spec_verify``: run the rank's
  side of the request. The leader resolves the seed and validates the
  request before it broadcasts; it alone samples and broadcasts each
  token (the engine's ``_sample``; a verify step's tokens and count),
  so every rank runs the same number of steps;
- ``batcher_load``: build the rank's side of a batched model
  (runtime/batcher.py ``BatcherRank``: its shard of the weights and of
  the paged pool, under pp its stage's; no scheduler); every rank
  reports;
- ``batcher_program``: one device program of the leader's scheduler
  (``kind`` "admit", "decode" or "spec") with its full host inputs,
  replayed in order (the JAX package's ``program_hook``). Under tp every
  rank samples from the gathered logits, the same bits on every rank;
  under pp the last stage samples and broadcasts; so every rank ends
  each program with the same tokens and history;
- ``stats`` / ``batcher_stats`` / ``reset_counts``: each rank's kernel
  launch counts and collective counts (a batcher rank adds its programs
  run and a digest of their outputs), gathered on the leader, or zeroed;
- ``stop`` / ``batcher_stop``: leave the loop and exit;
- ``release`` (``DLI_TP_KEEP_GROUPS=1``): drop the rank's model and its
  grid's subgroups, and wait for the next load.

With ``DLI_TP_KEEP_GROUPS=1`` (off by default; tests and the smoke,
which build many tp models in one process) a healthy group that an
engine or batcher stops is released instead, kept idle, and the next
``leader`` of its size on its device takes it, whatever its grid (a kept
pair serves tp=2, pp=2 or sp=2 alike: each load builds its subgroups),
so a script pays one spawn per group size; ``stop_idle_groups`` ends the
kept ones. Without
it every model spawns its followers and its unload joins them.

Failure is loud. A follower that fails to load makes the load fail; one
that fails in a request prints its traceback and exits, so the leader's
next collective raises and the request fails; the leader then marks the
group broken and every later op raises. A follower whose leader is gone
exits on its own (its parent is watched). ``stop`` joins every follower
with a timeout and raises if one had to be killed.
"""

from __future__ import annotations

import gc
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
REPLY_OPS = ("load", "stats", "reset_counts", "batcher_load",
             "batcher_stats")
STOP_OPS = ("stop", "batcher_stop")
# ops a follower runs by another name than "_" + op
_METHODS = {"batcher_program": "replay", "batcher_stats": "_stats"}
STOP_TIMEOUT_S = 60.0
# released groups kept for reuse (DLI_TP_KEEP_GROUPS), by (world, device)
_IDLE: dict = {}
_IDLE_LOCK = threading.Lock()

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


def rank_stats(group, device) -> dict:
    """This rank's kernel launches and, in a group, data collectives and
    hops and its place on the grid (p, s, t), and e under ep; with an
    expert group, ``route_digest``: the bits of the router inputs it
    routed since the counts were zeroed (``ExpertGroup.note_route``),
    equal on every rank of the group."""
    out = {"rank": group.rank if group else 0, "device": str(device),
           "launches": launch_counts()}
    if group is not None:
        out["collectives"] = dict(group.counts)
        axes = ("pp", "sp", "tp", "ep")[:4 if group.spec.ep > 1 else 3]
        out["grid"] = dict(zip(axes, group.coords))
        if group.experts is not None:
            out["route_digest"] = int(group.experts.route_sum)
    return out


def reset_counts(group):
    reset_launch_counts()
    if group is not None:
        group.counts = dict.fromkeys(group.counts, 0)
        if group.experts is not None:
            group.experts.route_sum.zero_()


def _keep_groups() -> bool:
    return os.environ.get("DLI_TP_KEEP_GROUPS") == "1"


def leader(world: int, device: torch.device) -> "Leader":
    """A group of ``world`` ranks on ``device``: a kept idle one
    (``DLI_TP_KEEP_GROUPS=1``) whose followers are all alive, else a new
    one."""
    if _keep_groups():
        with _IDLE_LOCK:
            idle = _IDLE.get((world, str(device)), [])
            while idle:
                ld = idle.pop()
                if len(ld.alive()) == world - 1:
                    return ld
                ld.broken = "a follower exited while the group was kept"
                ld._reap(force=True)
    return Leader(world, device)


def stop_idle_groups():
    """Stop and join every kept idle group."""
    with _IDLE_LOCK:
        kept = [ld for lds in _IDLE.values() for ld in lds]
        _IDLE.clear()
    for ld in kept:
        with ld._lock:
            ld._stop("stop")


class Leader:
    """Rank 0's side: the followers' processes and the group."""

    def __init__(self, world: int, device: torch.device):
        self._key = (world, str(device))
        if device.type == "cuda":
            # build every kernel once, before two ranks could race nvcc
            from distributed_llm_inferencing_tpu_torch.ops import build
            build.build_all()
        self._dir = tempfile.mkdtemp(prefix="dli-tp-")
        store = os.path.join(self._dir, "store")
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(
            target=follower_main, daemon=True, name=f"dli-tp-rank{r}",
            args=(r, world, str(device), store, os.getpid(),
                  torch.get_num_threads()))
            for r in range(1, world)]
        self.broken = None
        # one op at a time: a batcher's scheduler thread and a stats call
        # from another thread never interleave their broadcasts
        self._lock = threading.Lock()
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
        with self._lock:
            return self._run(op, kw, local)

    def _run(self, op: str, kw: dict, local):
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

    def stop(self, op: str = "stop"):
        """Stop (``op``: one of ``STOP_OPS``) and join every follower;
        raises if one had to be killed. With ``DLI_TP_KEEP_GROUPS=1`` a
        healthy group is released and kept idle instead."""
        with self._lock:
            if not (_keep_groups() and self._release()):
                self._stop(op)

    def _release(self) -> bool:
        """Have every follower drop its model, zero the collective counts
        and keep the group idle for ``leader``; False if it cannot be."""
        if self.broken or len(self.alive()) != len(self.procs):
            return False
        try:
            self.group.broadcast_object(("release", {}))
        except Exception as e:   # a follower already gone
            self.broken = f"release: {type(e).__name__}: {e}"
            return False
        self.group.release_grid()
        with _IDLE_LOCK:
            _IDLE.setdefault(self._key, []).append(self)
        return True

    def _stop(self, op: str):
        if not self.broken:
            try:
                self.group.broadcast_object((op, {}))
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
                  leader_pid: int, threads: int):
    """A follower's process: take the leader's ``threads`` intra-op
    threads, join the group, then serve the leader's ops until ``stop``
    (or ``batcher_stop``)."""
    torch.set_num_threads(threads)
    from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
        BatcherRank)
    from distributed_llm_inferencing_tpu_torch.runtime.engine import (
        InferenceEngine)
    _watch_leader(leader_pid)
    group = TPGroup(rank, world, torch.device(device), store)
    served = None   # the rank's engine or batcher side
    while True:
        op, kw = group.broadcast_object()
        if op in STOP_OPS:
            break
        if op == "release":
            served = None
            group.release_grid()
            gc.collect()
            if group.device.type == "cuda":
                torch.cuda.empty_cache()
            reset_counts(group)
            continue
        try:
            if op in ("load", "batcher_load"):
                served = (InferenceEngine if op == "load"
                          else BatcherRank)(**kw, group=group)
                out = None
            else:
                out = getattr(served, _METHODS.get(op, "_" + op))(**kw)
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
