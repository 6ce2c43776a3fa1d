"""Decode programs: one decode step over static buffers, captured once as a
CUDA graph and replayed.

Counterpart of the JAX package's compiled decode programs: the engine's
``_decode_fns`` cache by (SamplingParams, T), whose first call
``_timed_first_call`` observes as ``engine_jit_compile``
(runtime/engine.py), and the batcher's by (k, rows, table width, lora),
with ``warm_decode_programs`` (runtime/batcher.py). XLA compiles a decode
chunk into one program; on the card the counterpart is a captured CUDA
graph: every kernel of the step launched by one call from the host.

- ``DecodeProgram``: ``step()`` reads and writes only static tensors
  (inputs, state and outputs allocated before its first call and
  updated in place), so one capture serves every later call. With
  capture, the first call runs one real step eagerly on the owner's side
  stream — it loads every kernel library, sets every kernel attribute
  and lets cuBLAS pick its algorithms and make its workspace, none of
  which may happen inside a capture — then captures the step on that
  stream, which launches nothing. Every later call replays the graph.
- ``eager``: the same step function on the same buffers, never
  captured. It is the CPU path, the path with ``DLI_CUDA_GRAPHS=0``, and
  the tp engine's (runtime/engine.py: gloo collectives cannot be
  captured). Each is a rule decided before any attempt: with graphs on,
  a capture or replay error fails the request, never falls back.
- Launch counts (ops/launches.py): the warm-up step counts as the real
  step it is, the capture counts nothing, and every replay adds the
  launches its capture recorded, so the counts equal the launches the
  device ran.
- ``DecodePrograms``: what one owner's programs (an engine's or a
  batcher's) share. The owner keys and keeps each program with the state
  it runs over (the engine per batch size and ``SamplingParams``, capped
  FIFO as the JAX engine caps ``_decode_fns``, and its verify step per
  gamma and ``SamplingParams``; the batcher per decode route, and its
  speculative chunk's iteration per static draft width). Its graphs capture into one memory pool
  (``torch.cuda.graph_pool_handle``): they never replay at the same time,
  and a step leaves nothing of its own alive in the pool (its results
  land in the owner's static buffers), so one pool serves them all.
  ``release`` frees the graphs and the pool (``/unload_model``); a
  released program raises.

Beside other models. Every owner captures on a side stream that no
other live owner uses (``_side_stream``): another thread's work on a
stream being captured would join the capture. A capture, and the
package's other calls that synchronize or free across the device
(``empty_cache``), run one at a time (``_device_wide``): such a call
beside a capture invalidates it.

cuBLAS's workspaces. PyTorch keeps one per (cuBLAS handle, stream),
made at a handle's first GEMM on that stream and kept for the process
(32 MiB each on an H100): the warm-up step makes the one of (the
capturing thread's handle, the side stream), which the graph then bakes
in, and every thread that runs GEMMs (the batcher's scheduler, a
request's handler) makes one for its stream. They are cuBLAS's cache,
not the pool's, and PyTorch can only drop them all at once. An owner's
``release`` drops them only when no other owner on a card is alive
(``drop_idle_cublas_workspaces``), since another's graphs may have
baked any of them; until then they stay for later threads and captures
to reuse, bounded by the handles and pooled streams.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Callable, Optional

import torch

from distributed_llm_inferencing_tpu_torch.ops import launches
from distributed_llm_inferencing_tpu_torch.utils.metrics import Metrics

# every DecodePrograms not yet released: an owner whose graphs may have
# baked a cuBLAS workspace
_owners: "weakref.WeakSet[DecodePrograms]" = weakref.WeakSet()
_owners_lock = threading.Lock()
# held by a capture and by the package's other calls that synchronize or
# free across the whole device: such a call beside another thread's
# capture invalidates it, and torch.cuda.graph itself synchronizes and
# empties the cache before it begins
_device_wide = threading.Lock()


def enabled(device: torch.device) -> bool:
    """Capture decode programs: on a CUDA device unless
    ``DLI_CUDA_GRAPHS=0``."""
    return device.type == "cuda" and os.environ.get(
        "DLI_CUDA_GRAPHS", "1") not in ("0", "false", "")


def empty_cache(device: torch.device):
    """``torch.cuda.empty_cache()`` on a card, never beside a capture."""
    if device.type == "cuda":
        with _device_wide:
            torch.cuda.empty_cache()


def _drop_cublas_workspaces():
    torch._C._cuda_clearCublasWorkspaces()


def drop_idle_cublas_workspaces() -> bool:
    """Drop cuBLAS's cached workspaces if no owner of decode programs on a
    card is alive; returns whether it did."""
    with _owners_lock:
        if any(o.device.type == "cuda" for o in _owners):
            return False
        _drop_cublas_workspaces()
    return True


def _side_stream(device: torch.device):
    """A stream from PyTorch's pool that no live owner's graphs use: work
    of another thread on a stream being captured would join the capture."""
    with _owners_lock:
        taken = {o._graphs.side.cuda_stream for o in _owners
                 if o._graphs is not None and o.device == device}
    for _ in range(64):
        side = torch.cuda.Stream(device)
        if side.cuda_stream not in taken:
            return side
    raise RuntimeError("every pooled CUDA stream is a live owner's")


class CudaGraphs:
    """Captures steps as ``torch.cuda.CUDAGraph``s into one pool on one
    device, on a side stream of its own; ``pool_bytes`` is what the
    pool's segments hold after the last capture."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.side = _side_stream(device)
        self.pool_bytes = 0

    def warm(self, step: Callable[[], None]):
        """One real step on the side stream, ordered after and before the
        current stream's work (PyTorch's capture recipe)."""
        cur = torch.cuda.current_stream(self.device)
        self.side.wait_stream(cur)
        with torch.cuda.stream(self.side):
            step()
        cur.wait_stream(self.side)

    def capture(self, step: Callable[[], None]):
        graph = torch.cuda.CUDAGraph()
        # on this owner's stream, not torch's shared capture stream, and
        # thread_local: another model of the worker may launch, allocate
        # or replay on its own thread meanwhile
        with _device_wide, torch.cuda.graph(
                graph, pool=self.pool, stream=self.side,
                capture_error_mode="thread_local"):
            step()
        self.pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg["segment_pool_id"]) == tuple(self.pool))
        return graph


class DecodeProgram:
    """One decode step over static buffers: eager (``graphs`` None) or
    captured by ``graphs`` (``CudaGraphs``, or a stand-in with the same
    ``warm``/``capture``) at the first call and replayed after it. The
    capture's time is observed as ``engine_jit_compile``, the JAX
    engine's compile metric, in ``metrics``."""

    def __init__(self, step: Callable[[], None], graphs=None,
                 metrics: Optional[Metrics] = None):
        self.step = step
        self.graphs = graphs
        self.metrics = metrics
        self.graph = None
        self.record = None        # launches of one replay
        self.capture_s = None
        self.replays = 0
        self.released = False

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self):
        if self.released:
            raise RuntimeError("decode program released (model unloaded)")
        if self.graphs is None:
            self.step()
        elif self.graph is None:
            self.graphs.warm(self.step)      # the real step, counted
            t0 = time.perf_counter()
            with launches.recording() as record:
                graph = self.graphs.capture(self.step)
            self.capture_s = time.perf_counter() - t0
            self.graph, self.record = graph, record
            if self.metrics is not None:
                self.metrics.observe("engine_jit_compile", self.capture_s)
        else:
            self.graph.replay()
            launches.add(self.record)
            self.replays += 1

    def release(self):
        self.released = True
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.step = self.graphs = None


class DecodePrograms:
    """What one owner's decode programs share: the graphs' pool and side
    stream (made at the first capture), the ``metrics`` their captures
    are observed in, and ``release``."""

    def __init__(self, device: torch.device,
                 metrics: Optional[Metrics] = None, graphs_cls=CudaGraphs):
        self.device = device
        self.metrics = metrics or Metrics()
        self._graphs_cls = graphs_cls
        self._graphs = None
        self._live = []
        with _owners_lock:
            _owners.add(self)

    def make(self, step: Callable[[], None], capture: bool) -> DecodeProgram:
        """A program of ``step``, captured at its first call or eager as
        ``capture`` says; the owner keeps it, and may release it alone."""
        if capture and self._graphs is None:
            self._graphs = self._graphs_cls(self.device)
        prog = DecodeProgram(step, self._graphs if capture else None,
                             self.metrics)
        self._live = self.programs() + [prog]
        return prog

    def release(self):
        """Release every program and the pool, and on a card drop cuBLAS's
        workspaces if this was the last owner alive."""
        for prog in self._live:
            prog.release()
        self._live = []
        self._graphs = None
        with _owners_lock:
            _owners.discard(self)
        if self.device.type == "cuda":
            drop_idle_cublas_workspaces()

    def programs(self):
        """The programs not released yet."""
        return [p for p in self._live if not p.released]

    @property
    def pool(self):
        """The graphs' pool id (``segment_pool_id`` in
        ``torch.cuda.memory_snapshot()``), or None before a capture."""
        return None if self._graphs is None else self._graphs.pool

    def stats(self) -> dict:
        progs = self.programs()
        return {"decode_programs": len(progs),
                "decode_graphs_captured": sum(p.captured for p in progs),
                "decode_graph_pool_bytes": (self._graphs.pool_bytes
                                            if self._graphs else 0)}
