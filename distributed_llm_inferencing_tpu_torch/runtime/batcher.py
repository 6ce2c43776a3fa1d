"""Continuous batching over the paged KV cache: the scheduler core.

Counterpart of the JAX package's ``runtime/batcher.py``. A fixed pool of
decode *slots* advances every active request together, admitting queued
requests into freed slots mid-flight, so short and long generations share
the card without head-of-line blocking.

- **Chunked decode**: each step runs up to K decode iterations with
  sampling and the per-slot budget/eos lifecycle on the device
  (``Transformer.paged_chunk_step`` over one static ``PagedChunkState``);
  the host syncs once per chunk. Growth blocks for the whole chunk are
  allocated before it runs. The chunk's inputs go to the device in two
  packed copies (``_ChunkBuffers``, the JAX batcher's ints/floats
  packs), and each iteration is one decode program (runtime/graphs.py):
  a CUDA graph captured once per (rows, table width, decode route) and
  replayed K times, or the same step run eagerly on the CPU and with
  ``DLI_CUDA_GRAPHS=0``. ``warm_decode_programs`` captures ahead of
  traffic.
- **Wave admission**: queued requests are admitted in waves, one batched
  tail prefill (``Transformer.paged_prefill_tail``) with first-token
  sampling per (tail bucket, prefix bucket) group.
- **Prefix reuse**: the block pool's radix tree (runtime/block_pool.py)
  lets a request whose prompt shares whole blocks with an earlier one
  reuse that KV; admission prefills only the tail. Prompts whose uncached
  tail exceeds ``prefill_chunk`` blocks admit one chunk per step.
- **Preemption**: under memory pressure the youngest slot goes back to
  the queue; its blocks stay warm in the radix tree.
- **Host KV tier** (runtime/kvtier.py, on by default: ``kv_host_mb`` or
  ``DLI_KV_HOST_MB``, 256 MB; 0 disables it): a radix block the pool
  evicts is copied off the device into a bounded host arena keyed by its
  token-chain digest (``_offload_evicted``, the pool's evict hook, which
  runs before anything can overwrite the block); a later admission that
  misses the radix cache restores matching blocks from the arena in
  place (``_restore_from_arena``) instead of prefilling them, with the
  exact evicted bytes, so its tokens equal a cold prefill's.
- **Cross-node KV transfer** (runtime/kvwire.py): a request with
  ``kv_export`` parks its prompt's KV in the arena at finish
  (``_export_request_kv``), where a peer's ``/kv_fetch`` reads it; a
  request with ``kv_source`` (or the worker's ``prefetch_kv`` on the
  handler thread) pulls the missing blocks from that peer into the arena
  before admission restores them. Any failure costs a recompute, never
  the request (``kv_transfer_failures`` counts it).
- **Streaming and cancel**: a request's ``stream_cb(token)`` fires for
  each token as its chunk lands; ``cancel`` drops the request at the next
  step and returns its blocks to the pool there.

Sampling parameters ride as per-row tensors and each row draws from its
own (seed, step) stream (ops/sampling.py ``sample_batch``), so a request's
tokens are a pure function of (params, prompt, seed).

Admission (the JAX package's ``_admit_jit``) runs eagerly, and so do the
tier's restores: each writes the pool's tensors in place (``index_copy_``),
never new tensors, because the captured decode programs hold the pool's
addresses. Not ported yet (in ROADMAP order): overlapped dispatch,
migration, speculation, LoRA, the multi-host ``program_hook``, pipeline
parallelism and the phase profiler.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig
from distributed_llm_inferencing_tpu_torch.models.params import init_params
from distributed_llm_inferencing_tpu_torch.models.transformer import (
    PagedChunkState, Transformer)
from distributed_llm_inferencing_tpu_torch.ops import fused_decode
from distributed_llm_inferencing_tpu_torch.ops import kvblock_quant as kvq
from distributed_llm_inferencing_tpu_torch.ops.paged_kvcache import (
    init_paged_cache)
from distributed_llm_inferencing_tpu_torch.ops.quant import (
    maybe_quantize, maybe_quantize_embed)
from distributed_llm_inferencing_tpu_torch.ops.sampling import (
    SamplingParams, sample_batch)
from distributed_llm_inferencing_tpu_torch.runtime import graphs
from distributed_llm_inferencing_tpu_torch.runtime import kvtier as kvtier_mod
from distributed_llm_inferencing_tpu_torch.runtime import kvwire
from distributed_llm_inferencing_tpu_torch.runtime.block_pool import (
    BlockPool)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from distributed_llm_inferencing_tpu_torch.utils.device import resolve_device
from distributed_llm_inferencing_tpu_torch.utils.metrics import (
    KV_TIER_COUNTERS, Metrics)

log = logging.getLogger(__name__)

TAIL_BUCKETS_X_BS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)  # x block_size
PREFIX_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512)  # blocks


@dataclasses.dataclass
class BatchRequest:
    """One queued or active generation: the handle the caller waits on."""
    prompt: List[int]
    max_new_tokens: int
    sampling: SamplingParams
    eos_token_id: Optional[int] = None
    stream_cb: Optional[Callable[[int], None]] = None
    seed: int = 0    # output is a pure fn of (params, prompt, seed)
    # disaggregation: the peer to pull this request's prefix KV from
    # ({"url", "model"}), and whether to park its prompt's KV in the host
    # arena at finish for a decode peer's /kv_fetch
    kv_source: Optional[dict] = None
    kv_export: bool = False
    # results
    tokens: List[int] = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    # timing (host clock, seconds)
    submitted_at: float = dataclasses.field(default_factory=time.perf_counter)
    admitted_at: Optional[float] = None   # first admission wave dispatched
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    cost: Optional[dict] = None           # set once, at the terminal point
    # scheduling state
    _blocks: List[int] = dataclasses.field(default_factory=list)
    _preemptions: int = 0
    _cancelled: bool = False
    # chunked prefill: high-water of cached+chunk across passes, and how
    # many passes failed to advance it (bounded: two pool-sized prompts
    # could otherwise re-prefill each other's evictions forever)
    _chunk_high: int = 0
    _chunk_stalls: int = 0
    # prompt extent already counted as cached/uncached: a resumed chunk
    # pass or a re-admission re-matches the request's own blocks, which
    # is not a cache win
    _prefill_counted: int = 0
    # a no-free-slot pop found this request non-partial: skip re-popping
    # it until a slot frees
    _noslot_bounce: bool = False
    # cost ledger
    _cost_cached: int = 0
    _cost_uncached: int = 0
    _weight_passes: int = 0
    _arena_restored_bytes: int = 0
    _arena_offloaded_bytes: int = 0
    _kv_transfer_bytes: int = 0
    _peer_fetch_done: bool = False

    def wait(self, timeout: Optional[float] = None) -> List[int]:
        if not self.done.wait(timeout):
            raise TimeoutError("generation still running")
        if self.error:
            raise RuntimeError(self.error)
        return self.tokens

    def cancel(self):
        """Ask the scheduler to drop this request (frees its slot and
        blocks at the next chunk boundary; tokens so far are kept)."""
        self._cancelled = True

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return (self.first_token_at - self.submitted_at) * 1e3


class ContinuousBatcher:
    """Slot-based continuous batching scheduler on one device.

    Drive it with the owned background thread (``start()``/``stop()``) or
    synchronously through ``step()`` (tests, custom loops).
    """

    # Decode-chunk sizes (tokens per dispatched chunk), tried in order:
    # the engine's schedule. Each step picks the largest chunk some active
    # slot can fill; budget/eos masks handle slots that finish mid-chunk.
    DECODE_CHUNKS = InferenceEngine.DECODE_CHUNKS
    # Blocks per staged copy between the pool and the host tier (per leaf:
    # 64 MB at llama-3-8b's bf16 blocks of 16 tokens)
    STAGE_BLOCKS = 32
    # Rounding the chunk up past the largest remaining budget costs dead
    # steps for finished slots but saves a host round trip; allowed while
    # the overshoot stays this small.
    CHUNK_OVERSHOOT_MAX = 8

    def __init__(self, cfg: ModelConfig, params=None, *,
                 num_blocks: int = 512, block_size: int = 16,
                 slots: int = 8, max_seq: Optional[int] = None,
                 seed: int = 0, prefill_chunk: Optional[int] = 32,
                 decode_chunk_cap: Optional[int] = None, device=None,
                 metrics: Optional[Metrics] = None,
                 kv_host_mb: Optional[float] = None,
                 kv_digest_chunk: Optional[int] = None, kv_fetcher=None):
        self.metrics = metrics or Metrics()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.block_size = block_size
        self.slots = slots
        self.max_seq = min(max_seq or cfg.max_position_embeddings,
                           cfg.max_position_embeddings)
        self.max_blocks = -(-self.max_seq // block_size)
        # Chunked prefill: prompts whose uncached tail exceeds this many
        # blocks admit one chunk per step (KV lands in the radix cache,
        # the request requeues, the next match resumes there). Snapped to
        # a tail bucket. None/0 disables.
        if prefill_chunk:
            self.prefill_chunk = next(
                (m for m in TAIL_BUCKETS_X_BS if m >= prefill_chunk),
                TAIL_BUCKETS_X_BS[-1])
        else:
            self.prefill_chunk = None
        self._chunked_admissions = 0
        self._decode_chunk_cap = (int(decode_chunk_cap)
                                  if decode_chunk_cap else None)
        self.metrics.gauge("decode_tokens_per_weight_pass", 0.0)
        self.metrics.gauge("batcher_queue_depth", 0.0)

        dev = self.device
        if params is None:
            params = init_params(
                cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        else:   # as the engine: quantize a float tree on the device
            params = maybe_quantize_embed(maybe_quantize(
                {k: t.to(dev) for k, t in params.items()}, cfg), cfg)
        self.params = params
        self.model = Transformer(cfg, params)

        # +1: block 0 is the reserved dummy every inactive table entry
        # points at, so it never carries real KV
        self.pool = BlockPool(num_blocks + 1, block_size)
        [self._dummy] = self.pool.alloc(1)
        self.metrics.gauge("batcher_free_kv_blocks", self.pool.free_count())
        self.paged = init_paged_cache(cfg, num_blocks + 1, block_size,
                                      device=dev)
        self.block_tables = np.full((slots, self.max_blocks), self._dummy,
                                    np.int32)
        self.context_lens = np.zeros((slots,), np.int32)
        self._init_kvtier(kv_host_mb, kv_digest_chunk, kv_fetcher)
        self.active: List[Optional[BatchRequest]] = [None] * slots
        self._admit_order: collections.deque = collections.deque()

        self.queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._step_count = 0
        self._tokens_out = 0
        self._chunk_sizes: set = set()
        # the decode chunk's static buffers (made at the first chunk) and
        # the decode programs over them, by (route, captured)
        self._bufs: Optional[_ChunkBuffers] = None
        self.programs = graphs.DecodePrograms(dev, self.metrics)
        self._programs: dict = {}

    def _init_kvtier(self, kv_host_mb, kv_digest_chunk, kv_fetcher):
        """The host KV tier (the JAX batcher's settings): ``kv_host_mb``,
        else ``DLI_KV_HOST_MB``, else 256 MB of arena; 0 disables the tier
        and its advertisement. ``DLI_KV_HOST_DTYPE`` "int8" stores blocks
        quantized (ops/kvblock_quant.py), "native" (the default) the
        exact device bytes. ``kv_fetcher``: the worker's shared
        ``KVFetchClient``; a batcher without one builds its own at its
        first peer fetch."""
        if kv_host_mb is None:
            try:
                kv_host_mb = float(os.environ.get(
                    "DLI_KV_HOST_MB", kvtier_mod.DEFAULT_HOST_MB))
            except ValueError:
                kv_host_mb = kvtier_mod.DEFAULT_HOST_MB
        kv_dtype = os.environ.get("DLI_KV_HOST_DTYPE", "native")
        if kv_dtype not in kvtier_mod.HOST_DTYPES:
            kv_dtype = "native"
        self.kvtier = (kvtier_mod.KVTier(
            self.block_size, kv_host_mb,
            digest_chunk=kv_digest_chunk or kvtier_mod.DIGEST_CHUNK,
            dtype=kv_dtype)
            if kv_host_mb and kv_host_mb > 0 else None)
        self.kv_fetcher = kv_fetcher
        self._stage_bufs: Optional[List[torch.Tensor]] = None
        # single-flight peer fetches: concurrent fetches to one (peer,
        # model) coalesce onto one leader transfer of the digest union
        self._kvf_lock = threading.Lock()
        self._kvf_inflight: Dict[tuple, dict] = {}
        # the request whose admission prep is allocating: the arena
        # offloads its alloc triggers are billed to it
        self._admitting: Optional[BatchRequest] = None
        if self.kvtier is not None:
            self.pool.set_evict_hook(self._offload_evicted)
            for name in KV_TIER_COUNTERS:
                self.metrics.inc(name, 0)

    @property
    def decode_chunks(self):
        """DECODE_CHUNKS filtered by ``decode_chunk_cap`` (a live view:
        tests override DECODE_CHUNKS per instance)."""
        if self._decode_chunk_cap is None:
            return self.DECODE_CHUNKS
        return tuple(c for c in self.DECODE_CHUNKS
                     if c <= self._decode_chunk_cap) \
            or (min(self.DECODE_CHUNKS),)

    # ---- public API ---------------------------------------------------

    def make_request(self, prompt: Sequence[int],
                     max_new_tokens: int = 100,
                     sampling: Optional[SamplingParams] = None,
                     eos_token_id: Optional[int] = None,
                     stream_cb: Optional[Callable[[int], None]] = None,
                     seed: Optional[int] = None,
                     kv_source: Optional[dict] = None,
                     kv_export: bool = False,
                     kv_transfer_bytes: int = 0) -> BatchRequest:
        """Validate and build one request without enqueueing it (ValueError
        for a bad one), so a bad spec leaves no sibling enqueued.
        ``kv_transfer_bytes``: what a submit-time ``prefetch_kv`` moved,
        for the request's cost record."""
        if not prompt:
            raise ValueError("empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if seed is None:
            seed = time.time_ns() % (1 << 31)
        req = BatchRequest(prompt=[int(t) for t in prompt],
                           max_new_tokens=int(max_new_tokens),
                           sampling=sampling or SamplingParams(),
                           eos_token_id=eos_token_id, stream_cb=stream_cb,
                           seed=int(seed),
                           kv_source=(kv_source if isinstance(kv_source, dict)
                                      else None),
                           kv_export=bool(kv_export))
        req._kv_transfer_bytes = int(kv_transfer_bytes or 0)
        if len(req.prompt) + req.max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({len(req.prompt)}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds max_seq {self.max_seq}")
        return req

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 100,
               sampling: Optional[SamplingParams] = None,
               eos_token_id: Optional[int] = None,
               stream_cb: Optional[Callable[[int], None]] = None,
               seed: Optional[int] = None, **kv) -> BatchRequest:
        """``kv``: ``make_request``'s ``kv_source``, ``kv_export`` and
        ``kv_transfer_bytes``."""
        return self.submit_many([dict(
            prompt=prompt, max_new_tokens=max_new_tokens, sampling=sampling,
            eos_token_id=eos_token_id, stream_cb=stream_cb, seed=seed,
            **kv)])[0]

    def submit_many(self, specs: Sequence[dict]) -> List[BatchRequest]:
        """Validate and build every request of ``specs`` (keyword dicts
        of ``submit``) first — one bad spec raises and enqueues none —
        then enqueue them all in order."""
        return self.enqueue([self.make_request(**spec) for spec in specs])

    def enqueue(self, reqs: Sequence[BatchRequest]) -> List[BatchRequest]:
        """Enqueue built requests in order under one lock, with one wake
        of the scheduler."""
        reqs = list(reqs)
        if not reqs:
            return []
        with self._lock:
            self.queue.extend(reqs)
            depth = len(self.queue)
        self.metrics.inc("batcher_requests_submitted", len(reqs))
        self.metrics.gauge("batcher_queue_depth", depth)
        self._work.set()
        return reqs

    def inflight(self) -> int:
        """Requests the scheduler still owes an answer (active slots and
        queue): what a worker's drain waits on."""
        with self._lock:
            queued = len(self.queue)
        return sum(a is not None for a in self.active) + queued

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="batcher")
            self._thread.start()

    def stop(self):
        """Stop the loop and fail every in-flight or queued request, so no
        client waits out its timeout on an unloading worker."""
        self._stop.set()
        self._work.set()
        if self._thread:
            self._thread.join(timeout=30)
            self._thread = None
        for slot in range(self.slots):
            req = self.active[slot]
            if req is not None:
                req.error = req.error or "scheduler stopped"
                self._finish_slot(slot)
        with self._lock:
            drained = list(self.queue)
            self.queue.clear()
        for req in drained:
            self._fail_req(req, "scheduler stopped")
        self.programs.release()
        self._programs.clear()
        self._bufs = None

    def stats(self) -> dict:
        return {
            "slots": self.slots,
            "device": str(self.device),
            "active": sum(a is not None for a in self.active),
            "queued": len(self.queue),
            "steps": self._step_count,
            "tokens_out": self._tokens_out,
            "block_size": self.block_size,
            "blocks_free": self.pool.free_count(),
            "max_seq": self.max_seq,
            "chunk_sizes": sorted(self._chunk_sizes),
            "chunked_admissions": self._chunked_admissions,
            "prefill_chunk": self.prefill_chunk,
            "pool": self.pool.stats(),
            # the host KV tier and the prefix digests the master routes by
            "kvtier": (self.kvtier.stats()
                       if self.kvtier is not None else None),
            "prefix_digests": (self.kvtier.index.advertise()
                               if self.kvtier is not None else None),
            **self.programs.stats(),
        }

    # ---- device programs ----------------------------------------------

    def _tensor(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _run_admit(self, a: dict) -> List[int]:
        """One admission wave: batched tail prefill + first-token
        sampling. Returns first tokens [B] (one host sync)."""
        t = self._tensor
        last, self.paged = self.model.paged_prefill_tail(
            t(a["toks"], torch.int64), t(a["tail_len"]), t(a["tail_alloc"]),
            t(a["pfb"]), t(a["cached"]), self.paged)
        first = sample_batch(last, t(a["seeds"]), t(a["steps"]),
                             t(a["temps"], torch.float32), t(a["tks"]),
                             t(a["tps"], torch.float32),
                             t(a["ds"], torch.bool))
        return first.tolist()

    def _decode_program(self) -> graphs.DecodeProgram:
        """The decode program of this batcher's rows and table width (both
        fixed) on the current decode route (``fused_decode.eligible``, so
        a route change never replays the other route's graph): captured
        on a card unless ``DLI_CUDA_GRAPHS=0``, eager on the CPU."""
        if self._bufs is None:
            side = None
            if self.paged.quantized:   # the int8 chunk's side buffers
                side = (self.cfg.num_layers, self.slots,
                        max(self.DECODE_CHUNKS), self.cfg.num_kv_heads,
                        self.cfg.head_dim, self.model.dtype)
            self._bufs = _ChunkBuffers(self.slots, self.max_blocks,
                                       max(self.DECODE_CHUNKS), self.device,
                                       side)
        key = (fused_decode.eligible(self.cfg, self.paged.quantized),
               graphs.enabled(self.device))
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = self.programs.make(
                functools.partial(self.model.paged_chunk_step,
                                  self._bufs.state, self.paged, self._dummy),
                key[1])
        return prog

    def _run_decode(self, a: dict):
        """One K-token decode chunk: the inputs into the static buffers,
        the decode program K times. Returns (toks [K,R], emits [K,R]) as
        host arrays (one host sync)."""
        k = int(a["k"])
        step = self._decode_program()
        self._bufs.load(a)
        for _ in range(k):
            step()
        s = self._bufs.state
        if self.paged.quantized:
            self.model.paged_chunk_flush(s, self.paged, self._dummy, k)
        both = torch.stack([s.toks[:k], s.emits[:k].to(s.toks.dtype)])
        both = both.cpu().numpy()
        return both[0], both[1].astype(bool)

    @torch.inference_mode()
    def warm_decode_programs(self) -> int:
        """Capture the decode program of the current route ahead of
        traffic (the JAX batcher's ``warm_decode_programs``): one real
        step with every slot inactive, whose writes land in the reserved
        dummy block and whose outputs are dropped, then the capture.
        Returns the programs captured: 0 with graphs off or already
        warm."""
        if not graphs.enabled(self.device):
            return 0
        step = self._decode_program()
        if step.captured:
            return 0
        self._bufs.load(self._chunk_inputs(1))
        step()
        return 1

    # ---- host KV tier (offload on evict, restore on admission) --------

    def _stage(self) -> List[torch.Tensor]:
        """Per pool leaf, a host buffer of ``STAGE_BLOCKS`` blocks, each
        block contiguous ([STAGE_BLOCKS, L, bs, ...]): every copy between
        the pool and the arena goes through it. Page-locked on a card, so
        the copy engine moves it directly (a pageable copy is staged by
        the driver through a buffer of its own): a restore took 0.50 ms
        per 2 MB block through it against 1.28 pageable (PERF.md §5).
        Made at the first offload or restore."""
        if self._stage_bufs is None:
            pin = self.device.type == "cuda"
            self._stage_bufs = [
                torch.empty((self.STAGE_BLOCKS, lf.shape[0])
                            + tuple(lf.shape[2:]), dtype=lf.dtype,
                            pin_memory=pin)
                for lf in self.paged.leaves()]
        return self._stage_bufs

    def _read_blocks(self, ids: Sequence[int]) -> List[list]:
        """The pages of blocks ``ids`` on the host: per block, one page per
        pool leaf (k, v[, k_scale, v_scale]), each [L, bs, ...] in memory
        of its own. The device-to-host copies run on the stream that
        writes the pool, which waits for every write queued before them,
        and return before the caller can launch anything else."""
        out = []
        for c in range(0, len(ids), self.STAGE_BLOCKS):
            part = list(ids[c:c + self.STAGE_BLOCKS])
            idx = torch.as_tensor(part, dtype=torch.long, device=self.device)
            pages = []
            for lf, buf in zip(self.paged.leaves(), self._stage()):
                buf[:len(part)].copy_(lf.index_select(1, idx).transpose(0, 1))
                pages.append(kvq.to_numpy(buf[:len(part)]))
            out += [[p[j].copy() for p in pages] for j in range(len(part))]
        return out

    def _offload_evicted(self, evictions):
        """The pool's evict hook: copy each evicted radix block's device
        pages into the host arena under its token-chain digest. It runs
        inside ``pool.alloc``, after the block id went back to the free
        list and before anything that could overwrite it is launched
        (allocs run on the scheduler thread between programs, never in a
        capture). Blocks the arena already holds (a restored block's
        entry stays there) are not copied again."""
        ev = [(b, toks) for b, toks in evictions if toks]
        if not ev:
            return
        digs = [self.kvtier.block_digests(toks)[-1] for _, toks in ev]
        keep = [j for j, d in enumerate(digs)
                if not self.kvtier.arena.peek(d)]
        if not keep:
            return
        stored = nbytes = 0
        for j, cols in zip(keep, self._read_blocks([ev[j][0] for j in keep])):
            if self.kvtier.arena.put(digs[j], cols):
                stored += 1
                nbytes += sum(c.nbytes for c in cols)
        self.metrics.inc("kvtier_offloaded_blocks", stored)
        if self._admitting is not None and nbytes:
            # cost ledger: the alloc that evicted these blocks belongs to
            # the request admitting or growing
            self._admitting._arena_offloaded_bytes += nbytes

    def _run_restore(self, blocks: Sequence[int], pages: Sequence[tuple]):
        """Write host pages back into ``blocks`` of every pool leaf, in
        place (``index_copy_``): the captured decode programs hold the
        pool's addresses, so its tensors are never replaced. Each copy to
        the device completes before the staging buffer is filled again."""
        for c in range(0, len(blocks), self.STAGE_BLOCKS):
            part = pages[c:c + self.STAGE_BLOCKS]
            idx = torch.as_tensor(list(blocks[c:c + len(part)]),
                                  dtype=torch.long, device=self.device)
            for j, (lf, buf) in enumerate(zip(self.paged.leaves(),
                                              self._stage())):
                for i, pg in enumerate(part):
                    buf[i].copy_(kvq.to_torch(pg[j]))
                lf.index_copy_(1, idx, buf[:len(part)].to(
                    self.device).transpose(0, 1))

    def _restore_from_arena(self, prompt, n, prefix_blocks, cached):
        """Second-tier prefix lookup on a (partial) radix miss: restore
        the longest consecutive run of arena-held blocks that extends the
        radix match, register them in the radix tree, and return the
        extended (prefix_blocks, cached). Opportunistic: no free blocks or
        an arena LRU race fall back to prefilling that span. A native
        arena restores the exact evicted bytes (tokens equal a cold
        prefill's); an int8 one its bounded-error dequantization."""
        bs = self.block_size
        start = cached // bs
        limit = (n - 1) // bs   # >= 1 token must remain for the tail
        if start >= limit:
            return prefix_blocks, cached
        digs = self.kvtier.block_digests(prompt[:limit * bs])
        run = []
        for i in range(start, limit):
            if not self.kvtier.arena.peek(digs[i]):
                break
            run.append(digs[i])
        if not run:
            return prefix_blocks, cached
        blocks = self.pool.alloc(len(run))
        if blocks is None:
            return prefix_blocks, cached
        pages = []
        for d in run:
            pg = self.kvtier.arena.get(d)
            if pg is None:   # LRU-dropped by this alloc's own offloads
                break
            pages.append(pg)
        if len(pages) < len(blocks):
            self.pool.release(blocks[len(pages):])
            blocks = blocks[:len(pages)]
        if not blocks:
            return prefix_blocks, cached
        self._run_restore(blocks, pages)
        end = start + len(blocks)
        self.pool.insert_prefix(prompt[:end * bs], blocks, skip=start)
        self.metrics.inc("kvtier_restored_blocks", len(blocks))
        self.metrics.inc("kvtier_restored_tokens", len(blocks) * bs)
        if self._admitting is not None:
            self._admitting._arena_restored_bytes += sum(
                p.nbytes for pg in pages for p in pg)
        return prefix_blocks + blocks, end * bs

    def _get_kv_fetcher(self):
        """The worker's shared peer-fetch client, or this batcher's own."""
        if self.kv_fetcher is None:
            self.kv_fetcher = kvwire.KVFetchClient(metrics=self.metrics)
        return self.kv_fetcher

    def _fetch_into_arena(self, url, model, prompt, limit,
                          start: int = 0) -> int:
        """Pull the arena-missing chain digests of ``prompt``'s blocks
        ``[start, limit)`` from the peer at ``url`` into this arena. Any
        failure (transport, corrupt frame, blocks the peer lacks, shape
        drift) degrades to recompute. Returns the wire bytes stored.
        Single-flight: concurrent calls for one (peer, model) coalesce; the
        first leads and fetches the union of every caller's missing
        digests, the others wait for it and find their blocks in the
        arena, so each digest crosses the wire once."""
        bs = self.block_size
        digs = self.kvtier.block_digests(prompt[:limit * bs])
        want = [d for d in digs[start:limit]
                if not self.kvtier.arena.peek(d)]
        if not want:
            return 0
        key = (str(url), str(model))
        with self._kvf_lock:
            fl = self._kvf_inflight.get(key)
            leader = fl is None
            if leader:
                fl = {"pending": dict.fromkeys(want, True),
                      "event": threading.Event()}
                self._kvf_inflight[key] = fl
            else:
                for d in want:
                    fl["pending"].setdefault(d, True)
        if not leader:
            self.metrics.inc("kv_prefetch_coalesced")
            fl["event"].wait(timeout=90.0)
            return 0
        total = 0
        try:
            while True:
                with self._kvf_lock:
                    batch = [d for d in fl["pending"]
                             if not self.kvtier.arena.peek(d)]
                    fl["pending"].clear()
                if not batch:
                    break
                total += self._wire_fetch(url, model, batch)
        finally:
            with self._kvf_lock:
                self._kvf_inflight.pop(key, None)
            fl["event"].set()
        return total

    def _admit_fetched(self, digest, obj, expect) -> bool:
        """Check one fetched block's pages against the live pool's (shape
        and dtype; a quantized record's logical ones) before the arena
        takes it: a mismatched peer costs a recompute, never a fault in
        the restore."""
        if kvq.is_quantized_block(obj):
            specs = kvq.logical_specs(obj)
        else:
            specs = [(tuple(p.shape), p.dtype) for p in obj]
        if (len(specs) != len(expect)
                or any(shp != eshp or dt != edt
                       for (shp, dt), (eshp, edt) in zip(specs, expect))):
            self.metrics.inc("kv_transfer_failures")
            return False
        return self.kvtier.arena.put(digest, obj, count_offload=False)

    def _wire_fetch(self, url, model, want) -> int:
        """One transfer of ``want`` digests (the single-flight leader's
        round), each block checked and put in the arena as its frame
        decodes. A fault mid-stream keeps the blocks that landed; the rest
        recomputes."""
        expect = [((lf.shape[0],) + tuple(lf.shape[2:]),
                   kvq.host_dtype(lf.dtype)) for lf in self.paged.leaves()]
        w0 = time.perf_counter()
        blocks = bytes_in = 0
        try:
            for d, obj in self._get_kv_fetcher().fetch_stream(
                    url, model, want):
                if self._admit_fetched(d, obj, expect):
                    blocks += 1
                    bytes_in += kvwire.stored_nbytes(obj)
        except Exception:
            self.metrics.inc("kv_transfer_failures")
            log.warning("kv fetch from %s failed; recomputing", url,
                        exc_info=True)
        self.metrics.inc("kv_transfer_blocks", blocks)
        self.metrics.inc("kv_transfer_bytes", bytes_in)
        self.metrics.inc("kv_transfer_ms", (time.perf_counter() - w0) * 1e3)
        return bytes_in

    def prefetch_kv(self, prompt: Sequence[int], kv_source) -> int:
        """The transfer of a disaggregated request, on the caller's thread
        before submission (the worker's handler thread): pull the
        prompt's prefix blocks from the ``kv_source`` peer ({"url",
        "model"}) into the arena, so admission pays only the restore and
        co-resident decode streams never wait on the wire. Returns the
        bytes moved (0 on any failure: the request recomputes)."""
        if self.kvtier is None or not isinstance(kv_source, dict):
            return 0
        url = kv_source.get("url")
        if not url:
            return 0
        prompt = [int(t) for t in prompt]
        limit = (len(prompt) - 1) // self.block_size
        if limit <= 0:
            return 0
        try:
            return self._fetch_into_arena(
                url, str(kv_source.get("model") or ""), prompt, limit)
        except Exception:
            self.metrics.inc("kv_transfer_failures")
            return 0

    def _restore_from_peer(self, req, prompt, n, prefix_blocks, cached):
        """The scheduler-thread fetch of a request submitted with
        ``kv_source``: pull the missing block digests from the peer into
        the arena, which ``_restore_from_arena`` then restores. Returns
        (prefix_blocks, cached) unchanged. The worker never takes this
        path (it prefetches on its handler thread, ``prefetch_kv``, and
        submits without ``kv_source``); it is kept for direct batcher
        users, whose ``submit(kv_source=...)`` the JAX batcher accepts
        too."""
        src = req.kv_source
        if src is None or req._peer_fetch_done:
            return prefix_blocks, cached
        url = src.get("url")
        req._peer_fetch_done = True
        bs = self.block_size
        start, limit = cached // bs, (n - 1) // bs
        if not url or start >= limit:
            return prefix_blocks, cached
        req._kv_transfer_bytes += self._fetch_into_arena(
            url, str(src.get("model") or ""), prompt, limit, start=start)
        return prefix_blocks, cached

    def _export_request_kv(self, req):
        """Park the request's prompt KV in the arena under its token-chain
        digests, the blocks a peer's ``/kv_fetch`` asks for: at finish of
        a ``kv_export`` pass, while the request still owns its blocks, so
        the device bytes are exactly the prompt's. Blocks the arena holds
        already are skipped."""
        if req.error or not req._blocks:
            return
        bs = self.block_size
        n_full = min(len(req.prompt) // bs, len(req._blocks))
        if n_full <= 0:
            return
        digs = self.kvtier.block_digests(req.prompt[:n_full * bs])
        keep = [i for i in range(n_full)
                if not self.kvtier.arena.peek(digs[i])]
        if not keep:
            return
        stored = 0
        for i, cols in zip(keep, self._read_blocks(
                [req._blocks[i] for i in keep])):
            if self.kvtier.arena.put(digs[i], cols, count_offload=False):
                stored += 1
        self.metrics.inc("kvtier_exported_blocks", stored)

    # ---- scheduling ---------------------------------------------------

    def _bucket_tail(self, n: int) -> int:
        for m in TAIL_BUCKETS_X_BS:
            if n <= m * self.block_size:
                return min(m * self.block_size,
                           self.max_blocks * self.block_size)
        raise ValueError(f"tail of {n} tokens exceeds buckets")

    def _bucket_prefix(self, nb: int) -> int:
        for m in PREFIX_BUCKETS:
            if nb <= m:
                return min(m, self.max_blocks) if m else 0
        raise ValueError(f"prefix of {nb} blocks exceeds buckets")

    @staticmethod
    def _bucket_wave(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def _shared_wave_blocks(self, wave: List[dict], prompt: List[int]) -> int:
        """Longest common full-block prefix (in blocks) between `prompt`
        and any prompt already in the admission wave."""
        best = 0
        for m in wave:
            n = 0
            for a, b in zip(m["prompt"], prompt):
                if a != b:
                    break
                n += 1
            best = max(best, n // self.block_size)
        return best

    def _prep_admit(self, req: BatchRequest) -> Optional[dict]:
        """Host-side admission prep: radix prefix match + block allocation.
        None if blocks are unavailable (the caller preempts or requeues).
        A preempted request's generated tokens are part of the prefill:
        generation resumes where it left off, nothing is re-emitted."""
        self._admitting = req
        try:
            return self._prep_admit_blocks(req)
        finally:
            self._admitting = None

    def _prep_admit_blocks(self, req: BatchRequest) -> Optional[dict]:
        bs = self.block_size
        prompt = req.prompt + req.tokens
        n = len(prompt)
        # leave >= 1 token for the tail: prefill must produce the last
        # token's logits
        prefix_blocks, cached = self.pool.match_prefix(prompt[:n - 1])
        if self.kvtier is not None:
            # a disaggregated request pulls its missing prefix blocks
            # from its prefill peer into the arena, then the radix match
            # extends from the arena before anything is recomputed
            prefix_blocks, cached = self._restore_from_peer(
                req, prompt, n, prefix_blocks, cached)
            prefix_blocks, cached = self._restore_from_arena(
                prompt, n, prefix_blocks, cached)
        tail_alloc = []
        partial = False
        try:
            tail_len = n - cached
            cap = (self.prefill_chunk * bs) if self.prefill_chunk else None
            if cap is not None and tail_len > cap:
                # chunked prefill: the next `cap` tokens only (block
                # aligned), so >= 1 token remains for the sampling pass
                partial = True
                tail_len = cap
                n = cached + cap
            t = self._bucket_tail(tail_len)      # may raise ValueError
            tail_alloc = self.pool.alloc(t // bs)
            if tail_alloc is None:
                self.pool.release(prefix_blocks)
                return None
            pb = max(self._bucket_prefix(len(prefix_blocks)), 1)
        except ValueError:
            # refusing the request: drop the references this prep took
            self.pool.release(prefix_blocks)
            self.pool.release(tail_alloc or [])
            raise
        return {"t": t, "pb": pb, "n": n, "cached": cached,
                "tail_len": tail_len, "prompt": prompt, "partial": partial,
                "prefix_blocks": prefix_blocks, "tail_alloc": tail_alloc}

    def _admit_wave(self):
        """Admit queued requests into free slots as bucketed waves: one
        batched program per (tail, prefix) bucket group. A chunked-prefill
        (partial) member needs no slot — its chunk only writes KV into the
        radix cache — so a long prompt progresses even when every slot is
        busy. One partial per wave: it requeues to the front."""
        wave: List[dict] = []
        taken: set = set()
        while True:
            free = [i for i, a in enumerate(self.active)
                    if a is None and i not in taken]
            if not free:
                # no slot: only worth popping if the head could
                # chunk-admit (cheap length pre-filter; _prep_admit makes
                # the real partial decision)
                cap = (self.prefill_chunk or 0) * self.block_size
                with self._lock:
                    head = self.queue[0] if self.queue else None
                if (head is None or cap == 0 or head._noslot_bounce
                        or len(head.prompt) + len(head.tokens) - 1 <= cap):
                    break
            with self._lock:
                req = self.queue.popleft() if self.queue else None
            if req is None:
                break
            req._noslot_bounce = False
            if req._cancelled:
                self._fail_req(req, "cancelled")
                continue
            try:
                prep = self._prep_admit(req)
            except ValueError as e:
                self._fail_req(req, str(e))
                continue
            if (prep is not None and wave
                    and (self._shared_wave_blocks(wave, prep["prompt"])
                         * self.block_size > prep["cached"])):
                # an earlier wave member is about to insert a longer shared
                # prefix than this request would hit now: defer one step
                # so the re-match reuses those blocks
                self.pool.release(prep["prefix_blocks"])
                self.pool.release(prep["tail_alloc"])
                self._requeue_front(req)
                break
            if prep is None:
                if wave:
                    self._requeue_front(req)
                    break
                # free memory by preempting the youngest slot, then retry
                # this request first next step
                preempted = self._preempt_youngest()
                if not preempted and not self._admit_order:
                    self._fail_req(req, "KV block pool exhausted")
                else:
                    self._requeue_front(req)
                break
            prep["req"] = req
            if prep["partial"]:
                prep["slot"] = None
                wave.append(prep)
                break
            if not free:
                req._noslot_bounce = True
                self.pool.release(prep["prefix_blocks"])
                self.pool.release(prep["tail_alloc"])
                self._requeue_front(req)
                break
            prep["slot"] = free[0]
            taken.add(free[0])
            wave.append(prep)

        groups: dict = {}
        for m in wave:
            groups.setdefault((m["t"], m["pb"]), []).append(m)
        for (t, pb), members in groups.items():
            self._admit_group(t, pb, members)

    def _admit_group(self, t: int, pb: int, members: List[dict]):
        """One batched admission for wave members sharing a (tail bucket,
        prefix bucket); rows padded to a power of two (padding rows write
        only the reserved dummy block)."""
        bs = self.block_size
        b = self._bucket_wave(len(members))
        a = {"toks": np.zeros((b, t), np.int64),
             "tail_len": np.ones((b,), np.int32),
             "tail_alloc": np.full((b, t // bs), self._dummy, np.int32),
             "pfb": np.full((b, pb), self._dummy, np.int32),
             "cached": np.zeros((b,), np.int32),
             "seeds": np.zeros((b,), np.int32),
             "steps": np.zeros((b,), np.int32),
             "temps": np.ones((b,), np.float32),
             "tks": np.zeros((b,), np.int32),
             "tps": np.ones((b,), np.float32),
             "ds": np.zeros((b,), bool)}
        for j, m in enumerate(members):
            req, sp = m["req"], m["req"].sampling
            a["toks"][j, :m["tail_len"]] = \
                m["prompt"][m["cached"]:m["cached"] + m["tail_len"]]
            a["tail_len"][j] = m["tail_len"]
            a["tail_alloc"][j, :] = m["tail_alloc"]
            a["pfb"][j, :len(m["prefix_blocks"])] = m["prefix_blocks"]
            a["cached"][j] = m["cached"]
            a["seeds"][j] = req.seed
            a["steps"][j] = len(req.tokens)
            a["temps"][j] = sp.temperature
            a["tks"][j] = sp.top_k
            a["tps"][j] = sp.top_p
            a["ds"][j] = sp.do_sample
        w0 = time.perf_counter()
        for m in members:
            if m["req"].admitted_at is None:
                m["req"].admitted_at = w0
        first = self._run_admit(a)
        self.metrics.observe("batcher_admit_wave", time.perf_counter() - w0)
        for j, m in enumerate(members):
            self._post_admit(m, int(first[j]))

    def _post_admit(self, m: dict, first: int):
        """Register one admitted wave member: release padding blocks, enter
        the prompt's full blocks into the radix cache, bind the slot, and
        emit the sampled first token. A chunked-prefill member stops after
        the radix registration and requeues (its sampled token is not the
        prompt's last position and is dropped)."""
        req, slot = m["req"], m["slot"]
        bs = self.block_size
        n, cached, tail_len = m["n"], m["cached"], m["tail_len"]
        tail_alloc, prefix_blocks = m["tail_alloc"], m["prefix_blocks"]
        # cached tokens count only BEYOND the request's own earlier extent
        # (a resumed chunk pass re-matching its own blocks is no cache win)
        new_cached = max(0, cached - req._prefill_counted)
        self.metrics.inc("prefill_cached_tokens", new_cached)
        self.metrics.inc("prefill_uncached_tokens", tail_len)
        req._cost_cached += new_cached
        req._cost_uncached += tail_len
        req._prefill_counted = max(req._prefill_counted, n)
        tail_real = tail_alloc[: -(-tail_len // bs)]
        self.pool.release(tail_alloc[len(tail_real):])   # padding blocks

        n_full = n // bs
        skip = cached // bs
        if n_full > skip:
            self.pool.insert_prefix(m["prompt"][:n_full * bs],
                                    tail_real[:n_full - skip], skip)

        if m["partial"]:
            # the radix keeps the chunk's blocks alive (refcount-0 leaves
            # evict only under pool pressure)
            self.pool.release(prefix_blocks)
            self.pool.release(tail_real)
            self._chunked_admissions += 1
            if n > req._chunk_high:
                req._chunk_high = n
                req._chunk_stalls = 0
            else:
                req._chunk_stalls += 1
                self.metrics.inc("chunk_prefill_stalls")
                if req._chunk_stalls > 4:
                    self._fail_req(req, "KV block pool exhausted "
                                        "(chunked prefill made no progress)")
                    return
            if req._cancelled:
                self._fail_req(req, "cancelled")
            else:
                self._requeue_front(req)
            return

        req._blocks = prefix_blocks + tail_real
        self.block_tables[slot, :] = self._dummy
        self.block_tables[slot, :len(req._blocks)] = req._blocks
        self.context_lens[slot] = n
        self.active[slot] = req
        self._admit_order.append(slot)
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
        self._emit(req, first)
        if req.done.is_set() or len(req.tokens) >= req.max_new_tokens:
            self._finish_slot(slot)

    def _requeue_front(self, req: BatchRequest):
        """Put a request back at the queue head (chunked-prefill resume,
        preemption, wave overflow)."""
        self.metrics.inc("batcher_requeues")
        with self._lock:
            self.queue.appendleft(req)

    def _fail_req(self, req: BatchRequest, error: Optional[str] = None):
        """Terminal failure for a request that never reaches _finish_req
        (cancelled in queue, refused at admission, pool exhaustion,
        scheduler stop or error)."""
        req.error = req.error or error or "failed"
        req.finished_at = req.finished_at or time.perf_counter()
        self._observe_finished(req)
        req.done.set()

    def _emit(self, req: BatchRequest, token: int):
        """Append a sampled token; finish on eos (eos is not kept)."""
        if req.eos_token_id is not None and token == req.eos_token_id:
            self._finish_req(req)
            return
        req.tokens.append(token)
        self._tokens_out += 1
        if req.stream_cb:
            try:
                req.stream_cb(token)
            except Exception:
                # delivery is best-effort (the client likely went away):
                # the request runs on, its result whole, unstreamed
                log.warning("stream callback failed; tokens no longer "
                            "streamed for this request", exc_info=True)
                req.stream_cb = None

    def _finish_req(self, req: BatchRequest):
        if req.kv_export and self.kvtier is not None:
            # a disaggregated prefill pass: park the prompt's KV in the
            # arena while the blocks are still owned, for the decode
            # peer's /kv_fetch (best effort: the peer recomputes)
            try:
                self._export_request_kv(req)
            except Exception:
                log.warning("kv export failed; the decode peer will "
                            "recompute", exc_info=True)
        self.pool.release(req._blocks)
        req._blocks = []
        req.finished_at = time.perf_counter()
        self._observe_finished(req)
        req.done.set()

    def _cost_record(self, req: BatchRequest, end: float) -> dict:
        """The request's cost record. Queue ends when the first admission
        wave carrying it starts, prefill at the first token, decode at
        finish, so the three phases sum to the end-to-end span."""
        admitted = req.admitted_at if req.admitted_at is not None else end
        first = req.first_token_at if req.first_token_at is not None \
            else admitted
        return {
            "queue_ms": round(max(0.0, admitted - req.submitted_at) * 1e3, 3),
            "prefill_ms": round(max(0.0, first - admitted) * 1e3, 3),
            "decode_ms": round(max(0.0, end - first) * 1e3, 3),
            "prefill_cached_tokens": req._cost_cached,
            "prefill_uncached_tokens": req._cost_uncached,
            "decode_tokens": len(req.tokens),
            "weight_passes": req._weight_passes,
            "arena_restored_bytes": req._arena_restored_bytes,
            "arena_offloaded_bytes": req._arena_offloaded_bytes,
            "kv_transfer_bytes": req._kv_transfer_bytes,
        }

    def _observe_finished(self, req: BatchRequest):
        m = self.metrics
        m.inc("batcher_requests_failed" if req.error
              else "batcher_requests_completed")
        end = req.finished_at or time.perf_counter()
        m.observe("batcher_e2e_latency", end - req.submitted_at)
        if req.first_token_at is not None:
            m.observe("batcher_ttft", req.first_token_at - req.submitted_at)
        req.cost = self._cost_record(req, end)

    def _finish_slot(self, slot: int):
        req = self.active[slot]
        self.active[slot] = None
        self.block_tables[slot, :] = self._dummy
        self.context_lens[slot] = 0
        if slot in self._admit_order:
            self._admit_order.remove(slot)
        if req is not None and not req.done.is_set():
            self._finish_req(req)

    def _preempt_youngest(self) -> bool:
        """Free the most recently admitted slot, requeueing its request."""
        if not self._admit_order:
            return False
        self.metrics.inc("batcher_preemptions")
        slot = self._admit_order.pop()
        req = self.active[slot]
        self.active[slot] = None
        self.block_tables[slot, :] = self._dummy
        self.context_lens[slot] = 0
        if req is not None:
            self.pool.release(req._blocks)
            req._blocks = []
            req._preemptions += 1
            if req._preemptions > 5:
                self._fail_req(req, "preempted repeatedly: KV pool too small")
            else:
                self._requeue_front(req)
        return True

    def _ensure_growth(self, slot: int, k: int = 1) -> bool:
        """Make sure the slot owns every block a k-step chunk can write
        (positions [cl, cl + min(k, remaining) - 1]), allocated up front
        so the chunk runs without the host."""
        req = self.active[slot]
        pos0 = int(self.context_lens[slot])
        k_eff = max(1, min(k, req.max_new_tokens - len(req.tokens)))
        bi0 = pos0 // self.block_size
        bi1 = (pos0 + k_eff - 1) // self.block_size
        if bi1 >= self.max_blocks:
            return False
        need = [bi for bi in range(bi0, bi1 + 1)
                if self.block_tables[slot, bi] == self._dummy]
        if not need:
            return True
        self._admitting = req   # growth's offloads bill to this request
        try:
            got = self.pool.alloc(len(need))
        finally:
            self._admitting = None
        if got is None:
            return False
        for bi, blk in zip(need, got):
            self.block_tables[slot, bi] = blk
        req._blocks.extend(got)
        return True

    # ---- the step -----------------------------------------------------

    @torch.inference_mode()
    def step(self) -> int:
        """Admit a wave + one K-token decode chunk. Returns active slots."""
        t0 = time.perf_counter()
        busy = self._step_inner()
        m = self.metrics
        if busy:   # idle polls would drown the step histogram
            m.observe("batcher_step", time.perf_counter() - t0)
        m.gauge("batcher_queue_depth", len(self.queue))
        m.gauge("batcher_active_slots",
                sum(a is not None for a in self.active))
        m.gauge("batcher_free_kv_blocks", self.pool.free_count())
        if self.kvtier is not None:
            a = self.kvtier.arena.stats()
            m.gauge("kvtier_host_blocks", a["blocks"])
            m.gauge("kvtier_host_bytes", a["bytes"])
            m.gauge("kvtier_logical_bytes", a["logical_bytes"])
            m.gauge("kvtier_occupancy", a["occupancy"])
        return busy

    def _step_inner(self) -> int:
        # drop cancelled slots first: frees their blocks for admission
        for slot in range(self.slots):
            req = self.active[slot]
            if req is not None and req._cancelled:
                req.error = req.error or "cancelled"
                self._finish_slot(slot)

        self._admit_wave()

        active = [i for i, a in enumerate(self.active) if a is not None]
        if not active:
            return 0
        # chunk size: cover the largest remaining budget in one chunk when
        # the overshoot is small, else the largest chunk a slot can fill
        max_rem = max(self.active[i].max_new_tokens
                      - len(self.active[i].tokens) for i in active)
        chunks = self.decode_chunks
        up = min((c for c in chunks if c >= max_rem), default=None)
        if up is not None and up - max_rem <= self.CHUNK_OVERSHOOT_MAX:
            k = up
        else:
            k = next(c for c in chunks if c <= max_rem)

        # growth blocks for every position this chunk can write
        for slot in range(self.slots):
            while (self.active[slot] is not None
                   and not self._ensure_growth(slot, k)):
                # _preempt_youngest may free `slot` itself: the loop
                # condition re-checks
                if not self._preempt_youngest():
                    self.active[slot].error = "cannot grow KV allocation"
                    self._finish_slot(slot)
                    break
        active = [i for i, a in enumerate(self.active) if a is not None]
        if not active:
            return 0

        a = self._chunk_inputs(k)
        for i in active:
            req = self.active[i]
            sp = req.sampling
            a["tokens"][i] = req.tokens[-1]
            a["seeds"][i] = req.seed
            a["steps"][i] = len(req.tokens)
            a["temps"][i] = sp.temperature
            a["tks"][i] = sp.top_k
            a["tps"][i] = sp.top_p
            a["ds"][i] = sp.do_sample
            a["budget"][i] = min(k, req.max_new_tokens - len(req.tokens))
            if req.eos_token_id is not None:
                a["eos"][i] = req.eos_token_id
        self._dispatch_plain_chunk(active, a)
        return len([x for x in self.active if x is not None])

    def _chunk_inputs(self, k: int) -> dict:
        """A K-step chunk's host inputs with every slot inactive (budget
        0); the step fills in its active slots."""
        r = self.slots
        return {"k": k, "tokens": np.zeros((r,), np.int64),
                "bt": self.block_tables, "cl": self.context_lens,
                "seeds": np.zeros((r,), np.int32),
                "steps": np.zeros((r,), np.int32),
                "temps": np.ones((r,), np.float32),
                "tks": np.zeros((r,), np.int32),
                "tps": np.ones((r,), np.float32),
                "ds": np.zeros((r,), bool),
                "budget": np.zeros((r,), np.int32),
                "eos": np.full((r,), -1, np.int32)}

    def _dispatch_plain_chunk(self, active, a: dict) -> int:
        """One K-token decode chunk: run, sync, emit, finish dead slots.
        Returns tokens emitted."""
        k = int(a["k"])
        w0 = time.perf_counter()
        toks, emits = self._run_decode(a)
        self._step_count += 1
        self._chunk_sizes.add(k)
        self.metrics.observe("batcher_decode_chunk", time.perf_counter() - w0)
        return self._emit_chunk_outputs(active, toks, emits, k, a["budget"])

    def _emit_chunk_outputs(self, active, toks, emits, passes: int,
                            budget) -> int:
        """Emit each slot's tokens, advance its context, finish slots that
        hit eos (stopped before their budget) or their token limit."""
        emitted = 0
        for i in active:
            req = self.active[i]
            # emits[:, i] is True exactly on the slot's emitted prefix
            cnt = int(emits[:, i].sum())
            for tok in toks[:cnt, i]:
                self._emit(req, int(tok))
            emitted += cnt
            req._weight_passes += passes
            self.context_lens[i] += cnt
            if cnt < int(budget[i]) or len(req.tokens) >= req.max_new_tokens:
                self._finish_slot(i)
        # amortization: emitted tokens per weight-streaming pass (one pass
        # per decode iteration), the number continuous batching raises
        self.metrics.gauge("decode_tokens_per_weight_pass",
                           emitted / passes if passes else 0.0)
        self.metrics.inc("batcher_weight_passes", passes)
        self.metrics.inc("batcher_tokens_emitted", emitted)
        return emitted

    # ---- background loop ----------------------------------------------

    def _loop(self):
        while not self._stop.is_set():
            try:
                busy = self.step()
            except Exception as e:   # fail every waiter fast, then stop
                for slot in range(self.slots):
                    if self.active[slot] is not None:
                        self.active[slot].error = f"scheduler error: {e}"
                        self._finish_slot(slot)
                with self._lock:
                    drained = list(self.queue)
                    self.queue.clear()
                for req in drained:
                    self._fail_req(req, f"scheduler error: {e}")
                self._stop.set()
                return
            if not busy and not self.queue:
                self._work.wait(timeout=0.05)
                self._work.clear()


class _ChunkBuffers:
    """The decode chunk's static device state (``PagedChunkState``) for R
    slots over tables of MB blocks, as views of two packed buffers: int32
    [bt | cl | cur | seeds | steps0 | tks | budget | eos | ds | alive | cl0
    | t] and f32 [temps | tps], plus the outputs toks/emits [kmax, R] (and
    an int8 pool's side buffers and ``wrote``). ``load``
    writes a chunk's host inputs into one staging copy of each (pinned on
    a card) and copies each to the device once, without a sync: the
    chunk's own sync on its outputs comes before the next load."""

    ROW_FIELDS = ("cl", "cur", "seeds", "steps0", "tks", "budget", "eos",
                  "ds", "alive", "cl0")

    def __init__(self, rows: int, mb: int, kmax: int, device: torch.device,
                 side: Optional[tuple] = None):
        """``side``: (L, R, K, Hkv, hd, dtype) of an int8 pool's side
        buffers, else None."""
        self.rows, self.mb = rows, mb
        n = rows * mb + len(self.ROW_FIELDS) * rows + 1
        pin = device.type == "cuda"
        self.host_ints = torch.empty(n, dtype=torch.int32, pin_memory=pin)
        self.host_floats = torch.empty(2 * rows, dtype=torch.float32,
                                       pin_memory=pin)
        self.ints = torch.empty(n, dtype=torch.int32, device=device)
        self.floats = torch.empty(2 * rows, dtype=torch.float32,
                                  device=device)
        rows_at = {f: rows * (mb + i)
                   for i, f in enumerate(self.ROW_FIELDS)}
        fields = {f: self.ints[o:o + rows] for f, o in rows_at.items()}
        self.state = PagedChunkState(
            bt=self.ints[:rows * mb].view(rows, mb), **fields,
            t=self.ints[n - 1:], temps=self.floats[:rows],
            tps=self.floats[rows:],
            toks=torch.empty((kmax, rows), dtype=torch.int64, device=device),
            emits=torch.empty((kmax, rows), dtype=torch.bool, device=device))
        if side is not None:
            *shape, dtype = side
            self.state.side_k = torch.zeros(shape, dtype=dtype, device=device)
            self.state.side_v = torch.zeros(shape, dtype=dtype, device=device)
            self.state.wrote = torch.zeros((kmax, rows), dtype=torch.bool,
                                           device=device)
        self._host = {f: self.host_ints[o:o + rows].numpy()
                      for f, o in rows_at.items()}

    def load(self, a: dict):
        """One chunk's inputs (``ContinuousBatcher._chunk_inputs``'s
        keys), every slot's state reset: alive while it has budget, the
        step counter at 0."""
        r, mb = self.rows, self.mb
        ints = self.host_ints.numpy()
        ints[:r * mb] = np.asarray(a["bt"]).reshape(-1)
        h = self._host
        for f, key in (("cl", "cl"), ("cl0", "cl"), ("cur", "tokens"),
                       ("seeds", "seeds"),
                       ("steps0", "steps"), ("tks", "tks"),
                       ("budget", "budget"), ("eos", "eos"), ("ds", "ds")):
            h[f][:] = a[key]
        h["alive"][:] = np.asarray(a["budget"]) > 0
        ints[-1] = 0
        floats = self.host_floats.numpy()
        floats[:r] = a["temps"]
        floats[r:] = a["tps"]
        self.ints.copy_(self.host_ints, non_blocking=True)
        self.floats.copy_(self.host_floats, non_blocking=True)
