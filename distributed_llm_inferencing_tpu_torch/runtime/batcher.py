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
- **Overlapped dispatch** (``decode_overlap``, ``DLI_DECODE_OVERLAP``, on):
  when every active slot provably emits two whole chunks (no eos, no
  stream callback, the budget, nothing queued), the second chunk
  continues from the first's state on the device and the pair syncs once
  (``_step_overlapped``).
- **Speculation** (``speculative="ngram"``, ``spec_gamma``): each chunk
  runs ceil(K / (gamma+1)) verify iterations of
  ``Transformer.paged_spec_step`` (prompt-lookup drafts from a device
  copy of the token history, ``_hist``; up to gamma + 1 tokens per slot
  per weight pass), captured like the plain step and replayed. Wave mode
  (``DLI_SPEC_WAVE``, on) gives each request its own
  ``AdaptiveSpecController`` and the pass per-slot widths, so a
  draft-hostile request rides at width 0; off, one global controller
  picks the wave's gamma. ``DLI_SPEC_ADAPTIVE=0`` pins always-draft.
- **Live migration**: ``migrate_out`` flags a request; at the next step
  boundary (``_service_migrations``, first in the step) an active slot
  exports its KV through its context length into the arena and frees
  like a preemption, and the request ends "migrated" with a
  ``resume_record`` (the JAX batcher's keys) that ``make_request``'s
  ``resume`` continues from, on this package's batcher or the JAX one's.
- **Receive-overlapped restore** (``DLI_KV_WIRE_OVERLAP``, on): a
  scheduler-thread fetch of a ``kv_source`` restores runs of landed
  blocks in place while later frames arrive.
- **Multi-LoRA** (models/lora.py; the JAX batcher's slot plumbing): a
  bounded host adapter store (``load_adapter``, ``DLI_LORA_HOST_MB``)
  feeds ``DLI_LORA_SLOTS`` device slots of one pack (plus slot 0, the
  base model's zeros) at ``DLI_LORA_MAX_RANK``, allocated at the first
  adapter admission and rewritten in place, one slot at a time, when an
  admission binds an adapter to a slot (``_assign_lora_slot``): a
  captured program's addresses never move. A request pins its adapter
  from submit to its terminal outcome; its rows' slot ids ride the
  admission's and the chunk's inputs, and a wave with any adapter row
  runs the lora variant of each program (keyed like the JAX batcher's
  ``use_lora``; the fused kernel never takes it), a base-only wave the
  base program, untouched. An adapter's KV is its own: the radix cache
  matches and inserts it under a namespace per loaded adapter
  (runtime/block_pool.py), and the host tier, the peer fetch and the
  export leave adapter requests out, so no adapter request reuses base
  KV or the reverse (the JAX batcher's radix cache is adapter-blind,
  ROADMAP Queue C; the port's tokens equal its dedicated batcher's).

Sampling parameters ride as per-row tensors and each row draws from its
own (seed, step) stream (ops/sampling.py ``sample_batch``), so a request's
tokens are a pure function of (params, prompt, seed).

Admission (the JAX package's ``_admit_jit``) runs eagerly, and so do the
tier's restores: each writes the pool's tensors in place (``index_copy_``),
never new tensors, because the captured decode programs hold the pool's
addresses.

Tensor parallelism (``mesh_spec``, tp > 1; the JAX batcher's mesh and
its multi-host ``program_hook``): this batcher is the leader, rank 0,
and runs the whole scheduler (queue, admission waves, radix cache,
``BlockPool``, preemption, growth). Each device program it launches
(``_device_program``: admission, the decode chunk, the speculative
chunk) goes to the followers first with its full host inputs
(runtime/lockstep.py ``batcher_program``); each follower is a
``BatcherRank`` holding only its shard of the weights and of the pool
(the kv heads its q heads read), and replays the programs in order.
Every rank samples from the gathered logits, so every rank ends each
program with the same tokens (``rank_stats``: programs run and an
outputs digest per rank). The programs run eagerly (gloo collectives
cannot be captured; ``warm_decode_programs`` does nothing), the decode
route is ``paged_flash_decode`` (the fused kernel's gate is off under tp),
and what the followers could not replay is off or refused: the host KV
tier (ROADMAP Queue A item 9.12), ``kv_source`` / ``kv_export`` (9.13),
``resume`` and ``migrate_out`` (9.14), overlapped pairs (9.15) and
adapters (9.11). A failed program (a follower gone) fails the requests
in flight, marks the group broken and fails every later request at once.

Expert parallelism (``mesh_spec`` ep > 1, with tp, pp or both; the JAX
batcher serves tp and ep alike): every rank is a ``BatcherRank`` as
under tp, holding its ep slice of the routed experts (models/
transformer.py sums their partials over the tp × ep expert group) and
the pool of its tp cell's heads (latent attention's materialized
layout, which the pool always pins); the programs, the refusals and the
speculative chunk and wave are tp's.

Pipeline parallelism (``mesh_spec`` pp > 1, alone or with tp; the JAX
batcher's pp programs, parallel/paged_pipeline.py): the slot count and
each admission wave's rows are rounded up to a multiple of pp, the slots
form pp microbatches, and every stage is a ``BatcherRank`` holding its
layers and their slice of the pool, replaying the leader's programs as
under tp: admission, the decode chunk (paged and fused routes by the
same gate as at pp=1, an int8 pool's side buffers and flush) and the
speculative chunk with per-slot widths (wave mode). The last stage
samples; its outputs reach every rank in one broadcast per program.
Refused under pp as under tp: the host tier, ``kv_source`` /
``kv_export`` / ``/kv_fetch``, ``resume`` / ``/migrate_out`` (items
9.12-9.14), overlapped pairs stay off (9.15); LoRA adapters under pp are
a ``ValueError``, as in the JAX batcher. Batched serving with sp (or dp)
is refused, as the JAX batcher refuses it: the scheduler owns the batch
dimension. Not ported yet: the phase profiler.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import os
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from distributed_llm_inferencing_tpu_torch.models import lora as lora_mod
from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig
from distributed_llm_inferencing_tpu_torch.models.params import param_bytes
from distributed_llm_inferencing_tpu_torch.models.transformer import (
    PREGATHER_MAX_BYTES, LoRARows, PagedChunkState, SpecChunkState,
    Transformer)
from distributed_llm_inferencing_tpu_torch.ops import fused_decode
from distributed_llm_inferencing_tpu_torch.ops import kvblock_quant as kvq
from distributed_llm_inferencing_tpu_torch.ops.paged_kvcache import (
    init_paged_cache)
from distributed_llm_inferencing_tpu_torch.ops.sampling import (
    SamplingParams, sample_batch)
from distributed_llm_inferencing_tpu_torch.ops.speculative import (
    AdaptiveSpecController)
from distributed_llm_inferencing_tpu_torch.parallel import paged_pipeline
from distributed_llm_inferencing_tpu_torch.parallel.mesh import (
    MeshSpec, TPGroup, grid_coords, validate_spec)
from distributed_llm_inferencing_tpu_torch.parallel.sharding import (
    local_heads, stage_range)
from distributed_llm_inferencing_tpu_torch.runtime import graphs, lockstep
from distributed_llm_inferencing_tpu_torch.runtime import kvtier as kvtier_mod
from distributed_llm_inferencing_tpu_torch.runtime import kvwire
from distributed_llm_inferencing_tpu_torch.runtime.block_pool import (
    BlockPool)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine, rank_params)
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
    # multi-LoRA: the adapter the request runs through (None: base), the
    # device slot its rows gather (bound at admission prep, stable while
    # its refcount pins the slot), and the exactly-once pin release
    adapter: Optional[str] = None
    _lora_slot: int = 0
    _lora_released: bool = False
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
    # speculation: draft tokens accepted beyond one per iteration,
    # rejected, and proposed; and in wave mode the request's own drafting
    # controller (made at its first speculative chunk, or loaded from a
    # resume record), which follows it across preemptions
    _spec_acc: int = 0
    _spec_rej: int = 0
    _spec_drafted: int = 0
    _spec_ctl: Optional[object] = None
    # live migration: ``migrate_out`` flags the request, the scheduler
    # exports its KV and hands off ``resume_record`` at the next step
    # boundary; ``_migrated`` is the terminal "handed off" outcome
    _migrate_requested: bool = False
    _migrated: bool = False
    resume_record: Optional[dict] = None

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


class BatcherRank:
    """One rank's device side of a batched model: its model (under tp its
    shard of the weights, parallel/sharding.py), its pool of
    ``num_blocks`` blocks (under tp its shard: the kv heads its q heads
    read), and the device programs over them — admission
    (``_run_admit``), the decode chunk (``_run_decode``) and the
    speculative chunk (``_run_spec_decode``), run through
    ``_run_program``, which keeps a count and a digest of every
    program's outputs. ``ContinuousBatcher`` is rank 0 and adds the
    scheduler; a tp follower (runtime/lockstep.py) is a bare
    ``BatcherRank`` that holds no pool bookkeeping and ``replay``s the
    leader's programs in order. Every rank samples from the gathered
    logits, the same bits on every rank, so every rank ends each program
    with the same tokens; the digest shows it (``_stats``)."""

    DECODE_CHUNKS = InferenceEngine.DECODE_CHUNKS
    _PROGRAMS = {"admit": "_run_admit", "decode": "_run_decode",
                 "spec": "_run_spec_decode"}

    def __init__(self, cfg: ModelConfig, params=None, *, spec: MeshSpec,
                 num_blocks: int, block_size: int, slots: int, max_seq: int,
                 seed: int = 0, dummy: int = 0, device=None, loader=None,
                 group: Optional[TPGroup] = None):
        self.cfg = cfg
        self.metrics = Metrics()
        self._init_rank(params, spec=spec, num_blocks=num_blocks,
                        block_size=block_size, slots=slots, max_seq=max_seq,
                        seed=seed, dummy=dummy, device=device, loader=loader,
                        group=group)
        self._hist = None

    def _init_rank(self, params, *, spec: MeshSpec, num_blocks: int,
                   block_size: int, slots: int, max_seq: int, seed: int,
                   dummy: int, device, loader, group: Optional[TPGroup]):
        """The rank's weights (runtime/engine.py ``rank_params``), model,
        pool and program tables; ``dummy``: the reserved block every
        inactive table entry points at."""
        cfg = self.cfg
        self.group = group
        if group is not None:
            group.configure(spec)
        self.tp, self.pp = spec.tp, spec.pp
        self.device = dev = (group.device if group is not None
                             else resolve_device(device))
        self.block_size, self.slots, self.max_seq = block_size, slots, max_seq
        self.max_blocks = -(-max_seq // block_size)
        self.kv_heads = local_heads(cfg, spec)[1]
        rank = group.rank if group else 0
        self.params = rank_params(cfg, spec, rank, dev, params, seed, loader)
        self.model = Transformer(
            cfg, self.params, None if group is None else group.tp,
            layers=stage_range(cfg, spec, grid_coords(spec, rank)[0]),
            experts=None if group is None else group.experts)
        self.num_layers = len(self.model.layers)
        self._dummy = dummy
        self.paged = init_paged_cache(cfg, num_blocks, block_size,
                                      device=dev, num_kv_heads=self.kv_heads,
                                      num_layers=self.num_layers)
        # gloo collectives cannot be captured: in a group every program
        # runs eagerly
        self._capture = graphs.enabled(dev) and group is None
        # the decode chunk's static buffers (made at the first chunk) and
        # the decode programs over them, by (route, captured)
        self._bufs: Optional[_ChunkBuffers] = None
        self.programs = graphs.DecodePrograms(dev, self.metrics)
        self._programs: dict = {}
        # the speculative chunk's static buffers and program per gamma
        self._spec_progs: Dict[int, tuple] = {}
        self._programs_run = 0
        self._outputs_digest = 0

    def _run_program(self, kind: str, a: dict):
        """Device program ``kind`` on host inputs ``a``; its host outputs
        go into the rank's digest."""
        out = getattr(self, self._PROGRAMS[kind])(a)
        self._programs_run += 1
        for part in (out if isinstance(out, tuple) else (out,)):
            self._outputs_digest = zlib.crc32(
                np.ascontiguousarray(part).tobytes(), self._outputs_digest)
        return out

    def replay(self, kind: str, a: dict):
        """A follower's run of the leader's program ``kind``: the decode
        chunk sizes, the leader's ``DLI_FUSED_DECODE`` (so every pp stage
        takes the leader's decode route) and a speculative chunk's
        history ride in ``a``."""
        self.DECODE_CHUNKS = a.pop("chunks")
        fused = a.pop("fused_env")
        if fused is None:
            os.environ.pop("DLI_FUSED_DECODE", None)
        else:
            os.environ["DLI_FUSED_DECODE"] = fused
        if kind == "spec":
            self._hist = a.pop("hist")
        self._run_program(kind, a)

    def _stats(self, pool_blocks: Optional[List[int]] = None) -> dict:
        """The rank's launches and collectives, its programs run and
        their outputs' digest (equal on every rank), and with
        ``pool_blocks`` those blocks of its pool shard on the host
        (``PagedKVCache.leaves``)."""
        out = dict(lockstep.rank_stats(self.group, self.device),
                   programs_run=self._programs_run,
                   outputs_digest=self._outputs_digest,
                   param_bytes=param_bytes(self.params),
                   layers=[self.model.layer_range.start,
                           self.model.layer_range.stop])
        if pool_blocks is not None:
            ix = torch.as_tensor(pool_blocks, device=self.device)
            out["pool"] = [t[:, ix].cpu() for t in self.paged.leaves()]
        return out

    def _reset_counts(self):
        lockstep.reset_counts(self.group)

    def release_programs(self):
        self.programs.release()
        self._programs.clear()
        self._spec_progs.clear()
        self._bufs = None

    def _tensor(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _run_admit(self, a: dict) -> List[int]:
        """One admission wave: batched tail prefill + first-token
        sampling; with ``a["aids"]`` (a wave with adapter rows) each row
        gathers its slot of the pack. Returns first tokens [B] (one host
        sync)."""
        t = self._tensor
        lora = (LoRARows(self._lora_pack, t(a["aids"], torch.int64))
                if "aids" in a else None)
        args = (t(a["toks"], torch.int64), t(a["tail_len"]),
                t(a["tail_alloc"]), t(a["pfb"]), t(a["cached"]), self.paged)
        if self.pp > 1:   # the last stage samples, every rank gets it
            last = paged_pipeline.prefill_tail_pp(self.model, self.group,
                                                  *args)
        else:
            last, self.paged = self.model.paged_prefill_tail(*args, lora)
        first = torch.empty(len(a["toks"]), dtype=torch.int64,
                            device=self.device)
        if last is not None:
            first = sample_batch(last, t(a["seeds"]), t(a["steps"]),
                                 t(a["temps"], torch.float32), t(a["tks"]),
                                 t(a["tps"], torch.float32),
                                 t(a["ds"], torch.bool)).long()
        if self.pp > 1:
            first = paged_pipeline.broadcast_from_last(self.group, first)
        return first.tolist()

    def _decode_program(self, use_lora: bool = False
                        ) -> graphs.DecodeProgram:
        """The decode program of this batcher's rows and table width (both
        fixed) on the current decode route (``fused_decode.eligible``, so
        a route change never replays the other route's graph), and with
        ``use_lora`` its variant that adds each slot's adapter delta
        (never fused): captured on a card unless ``DLI_CUDA_GRAPHS=0``,
        eager on the CPU and under tp."""
        if self._bufs is None:
            side = None
            if self.paged.quantized:   # the int8 chunk's side buffers
                side = (self.num_layers, self.slots,
                        max(self.DECODE_CHUNKS), self.kv_heads,
                        self.cfg.head_dim, self.model.dtype)
            self._bufs = _ChunkBuffers(self.slots, self.max_blocks,
                                       max(self.DECODE_CHUNKS), self.device,
                                       side)
        key = (fused_decode.eligible(self.cfg, self.paged.quantized,
                                     self.tp) and not use_lora,
               use_lora, self._capture)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = self.programs.make(
                functools.partial(self.model.paged_chunk_step,
                                  self._bufs.state, self.paged, self._dummy,
                                  self._lora_rows(self._bufs.state.aids,
                                                  use_lora)),
                key[2])
        return prog

    def _lora_rows(self, ids, use_lora: bool) -> Optional[LoRARows]:
        return LoRARows(self._lora_pack, ids) if use_lora else None

    def _launch_decode(self, a: dict, cont: bool = False):
        """Queue one K-token decode chunk: the inputs into the static
        buffers (``cont``: the second chunk of an overlapped pair, whose
        state continues from the first's on the device, with no host
        input), the decode program K times. Returns its (toks, emits)
        [2, K, R] on the device, a copy the next chunk cannot overwrite;
        nothing syncs."""
        k = int(a["k"])
        step = self._decode_program(bool(np.any(a["aids"])))
        if cont:
            self._bufs.advance()
        else:
            self._bufs.load(a)
        if self.pp > 1:
            return paged_pipeline.decode_chunk_pp(
                self.model, self.group, self._bufs.state, self.paged,
                self._dummy, k)
        for _ in range(k):
            step()
        s = self._bufs.state
        if self.paged.quantized:
            self.model.paged_chunk_flush(s, self.paged, self._dummy, k)
        return torch.stack([s.toks[:k], s.emits[:k].to(s.toks.dtype)])

    def _run_decode(self, a: dict):
        """One K-token decode chunk. Returns (toks [K,R], emits [K,R]) as
        host arrays (one host sync)."""
        both = self._launch_decode(a).cpu().numpy()
        return both[0], both[1].astype(bool)

    def _spec_program(self, gamma: int, use_lora: bool = False):
        """(buffers, program) of the speculative chunk at static width
        ``gamma`` over this batcher's rows and table width (``use_lora``:
        its variant with the slots' adapter deltas): the iteration
        ``Transformer.paged_spec_step`` captured on a card unless
        ``DLI_CUDA_GRAPHS=0``, eager on the CPU and under tp; the chunk
        replays it K
        times (its buffers hold K up to the largest decode chunk)."""
        capture = self._capture
        ent = self._spec_progs.get((gamma, use_lora, capture))
        if ent is None:
            # the base and lora variants share one set of buffers
            bufs = next((b for (g, _, c), (b, _) in self._spec_progs.items()
                         if g == gamma and c == capture), None)
            cfg = self.cfg
            kmax = -(-max(self.DECODE_CHUNKS) // (gamma + 1))
            row_bytes = (2 * self.model.dtype.itemsize * self.num_layers
                         * self.max_blocks * self.block_size
                         * self.kv_heads * cfg.head_dim)
            bufs = bufs or _SpecBuffers(
                self.slots, self.max_blocks, self.max_seq + 1, kmax, gamma,
                cfg, self.num_layers, self.kv_heads, self.model.dtype,
                self.device,
                pool_tokens=(self.max_blocks * self.block_size
                             if self.slots * row_bytes
                             <= PREGATHER_MAX_BYTES else 0))
            prog = self.programs.make(
                functools.partial(self.model.paged_spec_step, bufs.state,
                                  self.paged, gamma,
                                  self._lora_rows(bufs.state.aids,
                                                  use_lora)), capture)
            ent = self._spec_progs[gamma, use_lora, capture] = (bufs, prog)
        return ent

    def _run_spec_decode(self, a: dict):
        """One speculative chunk of ``a["k"]`` verify iterations at static
        width ``a["gamma"]`` (per-slot widths ``a["gammas"]``): inputs
        and the history into the static buffers, the pool gathered once
        when it fits, the program K times, the kept side entries flushed
        into the pool. Returns (toks [K,R,G+1], keeps [K,R], eos_seen
        [K,R]) as host arrays (one host sync)."""
        k, g = int(a["k"]), int(a["gamma"])
        bufs, prog = self._spec_program(g, bool(np.any(a["aids"])))
        bufs.load(a, self._hist)
        st = bufs.state
        if st.pool_k is not None:
            self.model.paged_spec_gather(st, self.paged)
        if self.pp > 1:
            out = paged_pipeline.spec_chunk_pp(
                self.model, self.group, st, self.paged, self._dummy, k,
                g).cpu().numpy()
            return (out[..., :g + 1], out[..., g + 1],
                    out[..., g + 2].astype(bool))
        for _ in range(k):
            prog()
        self.model.paged_spec_flush(st, self.paged, self._dummy)
        r = self.slots
        out = torch.cat([st.toks[:k].reshape(-1), st.keeps[:k].reshape(-1),
                         st.eos_out[:k].reshape(-1).long()]).cpu().numpy()
        n = k * r * (g + 1)
        return (out[:n].reshape(k, r, g + 1),
                out[n:n + k * r].reshape(k, r),
                out[n + k * r:].reshape(k, r).astype(bool))



class ContinuousBatcher(BatcherRank):
    """Slot-based continuous batching scheduler on one device, or the
    leader of a tp group (``mesh_spec``) whose followers replay its
    device programs (``BatcherRank``).

    Drive it with the owned background thread (``start()``/``stop()``) or
    synchronously through ``step()`` (tests, custom loops).
    """

    # Decode-chunk sizes (DECODE_CHUNKS, tokens per dispatched chunk) are
    # tried in order: the engine's schedule. Each step picks the largest
    # chunk some active slot can fill; budget/eos masks handle slots that
    # finish mid-chunk.
    # Blocks per staged copy between the pool and the host tier (per leaf:
    # 64 MB at llama-3-8b's bf16 blocks of 16 tokens)
    STAGE_BLOCKS = 32
    # Rounding the chunk up past the largest remaining budget costs dead
    # steps for finished slots but saves a host round trip; allowed while
    # the overshoot stays this small.
    CHUNK_OVERSHOOT_MAX = 8
    # blocks landed per in-place restore while a peer fetch still
    # receives (the JAX batcher's receive-overlap cadence)
    RESTORE_RUN = 8

    def __init__(self, cfg: ModelConfig, params=None, *,
                 num_blocks: int = 512, block_size: int = 16,
                 slots: int = 8, max_seq: Optional[int] = None,
                 seed: int = 0, prefill_chunk: Optional[int] = 32,
                 decode_chunk_cap: Optional[int] = None, device=None,
                 metrics: Optional[Metrics] = None,
                 kv_host_mb: Optional[float] = None,
                 kv_digest_chunk: Optional[int] = None, kv_fetcher=None,
                 speculative: Optional[str] = None, spec_gamma: int = 4,
                 spec_adaptive: Optional[bool] = None,
                 spec_wave: Optional[bool] = None,
                 decode_overlap: Optional[bool] = None,
                 mesh_spec: Optional[MeshSpec] = None,
                 loader: Optional[Callable] = None):
        """``mesh_spec`` (tp) and ``loader`` (each rank reads a checkpoint
        and keeps its cut) as the engine's."""
        self.metrics = metrics or Metrics()
        self.device = resolve_device(device)
        # the paged pool holds latent attention materialized, per head,
        # as the JAX batcher pins it (the latent layout is the engine's)
        self.cfg = cfg = cfg.replace(mla_latent_cache=False)
        self.mesh_spec = spec = mesh_spec or MeshSpec()
        if spec.sp > 1:
            raise ValueError(
                f"batched serving shards tensors (tp) and pipeline stages "
                f"(pp); sp={spec.sp} unsupported (the slot scheduler owns "
                "the batch dim), as in the JAX batcher")
        validate_spec(spec, cfg)
        if spec.world > 1 and kv_host_mb:
            raise ValueError(
                f"the host KV tier under tp or pp (kv_host_mb={kv_host_mb}) "
                "is a later slice of the port (ROADMAP Queue A item 9.12); "
                "load with kv_host_mb 0 or without a mesh")
        # the slots microbatch over the pp stages (the JAX batcher's rule)
        slots = -(-slots // spec.pp) * spec.pp
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
        self.metrics.inc("batcher_requests_migrated", 0)
        # overlapped pairs continue a chunk on the device with no program
        # boundary a follower could replay: off under tp or pp (the JAX
        # hook's rule; ROADMAP Queue A item 9.15)
        self._init_speculation(speculative, spec_gamma, spec_adaptive,
                               spec_wave,
                               False if spec.world > 1 else decode_overlap)

        # +1: block 0 is the reserved dummy every inactive table entry
        # points at, so it never carries real KV
        self.pool = BlockPool(num_blocks + 1, block_size)
        [dummy] = self.pool.alloc(1)
        self.metrics.gauge("batcher_free_kv_blocks", self.pool.free_count())
        # the weights (a float tree quantized on the device, as the
        # engine's), the pool and the programs: here, and under tp on
        # every follower (``batcher_load``)
        rank = dict(spec=spec, num_blocks=num_blocks + 1,
                    block_size=block_size, slots=slots,
                    max_seq=self.max_seq, seed=seed, dummy=dummy,
                    loader=loader)
        self._leader = None
        if spec.world > 1:
            self._leader = lockstep.leader(spec.world, self.device)
            cpu = (None if params is None
                   else {k: t.cpu() for k, t in params.items()})
            try:
                self._leader.run(
                    "batcher_load", dict(rank, cfg=cfg, params=cpu,
                                         device=str(self.device)),
                    lambda: self._init_rank(params, device=self.device,
                                            group=self._leader.group,
                                            **rank))
            except BaseException:
                self._leader.stop("batcher_stop")
                raise
        else:
            self._init_rank(params, device=self.device, group=None, **rank)
        # every rank's weight bytes, in rank order (/health)
        self._rank_param_bytes = [s["param_bytes"]
                                  for s in self.rank_stats()]
        self.block_tables = np.full((slots, self.max_blocks), self._dummy,
                                    np.int32)
        self.context_lens = np.zeros((slots,), np.int32)
        # no host tier under tp or pp (its restores would write one rank's
        # pool alone; ROADMAP Queue A item 9.12)
        self._init_kvtier(0 if spec.world > 1 else kv_host_mb,
                          kv_digest_chunk, kv_fetcher)
        self._init_lora()
        self.active: List[Optional[BatchRequest]] = [None] * slots
        self._admit_order: collections.deque = collections.deque()

        self.queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # why the scheduler loop stopped on an error: later requests fail
        # at once instead of waiting on a loop that is gone
        self._error: Optional[str] = None
        self._step_count = 0
        self._tokens_out = 0
        self._chunk_sizes: set = set()

    def _init_speculation(self, speculative, spec_gamma, spec_adaptive,
                          spec_wave, decode_overlap):
        """The JAX batcher's speculation and overlap settings.

        - ``decode_overlap`` (else ``DLI_DECODE_OVERLAP``, on): a chunk
          pair whose every slot provably emits the whole chunk twice (no
          eos, no stream callback, budget for both, nothing queued) runs
          back to back, the second fed on the device by the first's last
          tokens, with one sync for the pair (``_step_overlapped``).
        - ``speculative`` ("ngram" or None) and ``spec_gamma``: on-device
          prompt-lookup drafting (``Transformer.paged_spec_step``), up to
          gamma + 1 tokens per slot per iteration; greedy tokens equal
          plain decode, sampled rows keep the target distribution.
        - ``spec_adaptive`` (else ``DLI_SPEC_ADAPTIVE``, on): controllers
          (ops/speculative.py) shrink gamma or fall back to plain chunks
          when acceptance or measured tok/s says drafting loses.
        - ``spec_wave`` (else ``DLI_SPEC_WAVE``, on): each request keeps
          its own controller and the shared verify pass takes per-slot
          widths as data, so a draft-hostile request rides it at width 0
          as plain decode while its chunk-mates keep drafting; off, one
          global controller picks one gamma for the wave."""
        def env_on(name):
            return os.environ.get(name, "1") not in ("0", "false")
        if decode_overlap is None:
            decode_overlap = env_on("DLI_DECODE_OVERLAP")
        self.decode_overlap = bool(decode_overlap)
        self._overlapped_dispatches = 0
        self.metrics.inc("batcher_overlapped_dispatches", 0)
        if speculative not in (None, "ngram"):
            raise ValueError(f"unknown speculative mode {speculative!r}")
        self.speculative = speculative
        self.spec_gamma = int(spec_gamma)
        self._spec_accepted = 0
        if spec_adaptive is None:
            spec_adaptive = env_on("DLI_SPEC_ADAPTIVE")
        self._spec_adaptive = bool(spec_adaptive)
        if spec_wave is None:
            spec_wave = env_on("DLI_SPEC_WAVE")
        self.spec_wave = bool(spec_wave) and bool(speculative)
        self._spec_wave_dispatches = 0
        # wave mode's cross-request arbitration: the throughput EMAs and
        # probe clocks measure the host, so a fresh request's controller
        # starts from them (_seed_wave_ctl)
        self._wave_shared = {"spec_tps": None, "plain_tps": None,
                             "since_plain_probe": 0, "since_probe": 0}
        if self.spec_wave:
            for name in ("spec_wave_dispatches", "spec_wave_drafted_tokens",
                         "spec_wave_accepted_tokens",
                         "spec_wave_plain_rides"):
                self.metrics.inc(name, 0)
            self.metrics.gauge("spec_wave_drafting_slots", 0.0)
            self.metrics.gauge("spec_wave_gamma_mean", 0.0)
        # spec_gamma < 1 asks for no drafts: no controller, plain chunks
        self._spec_ctl = None
        if (speculative and self._spec_adaptive and self.spec_gamma >= 1
                and not self.spec_wave):
            self._spec_ctl = AdaptiveSpecController(self.spec_gamma)
        # the drafting history on the host, kept incrementally: row i
        # holds slot i's prompt and emitted tokens; each speculative
        # chunk copies it into its device buffer
        self._hist = (np.zeros((self.slots, self.max_seq + 1), np.int32)
                      if speculative else None)

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
        # receive-overlapped restore of a peer fetch (_restore_from_peer)
        self._wire_overlap = os.environ.get(
            "DLI_KV_WIRE_OVERLAP", "1") not in ("0", "false", "no", "")
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
            self.metrics.gauge("kv_restore_overlap_ratio", 0.0)

    def _init_lora(self):
        """The adapter plane (the JAX batcher's): a host store, the slot
        names (index 0: the base model), refcounts, LRU clocks, and each
        loaded adapter's generation (its radix namespace). The device
        pack is made at the first adapter admission."""
        self._lora_lock = threading.Lock()
        self._lora_store = lora_mod.LoRAHostStore()
        self._lora_max_rank = lora_mod.max_rank_from_env()
        self._lora_slot_names: List[Optional[str]] = \
            [None] * (lora_mod.slots_from_env() + 1)
        self._lora_refs: Dict[str, int] = {}
        self._lora_last_use: Dict[str, int] = {}
        self._lora_seq = 0
        self._lora_gen: Dict[str, int] = {}
        self._lora_pack: Optional[dict] = None
        self.metrics.gauge("lora_host_bytes", 0.0)
        self.metrics.gauge("lora_host_adapters", 0.0)
        for name in ("lora_loads", "lora_evictions", "lora_load_failures",
                     "lora_requests"):
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
                     kv_transfer_bytes: int = 0,
                     resume: Optional[dict] = None,
                     adapter: Optional[str] = None) -> BatchRequest:
        """Validate and build one request without enqueueing it (ValueError
        for a bad one), so a bad spec leaves no sibling enqueued.
        ``adapter``: a loaded LoRA adapter (a resume record's wins); the
        last check pins it (ValueError for one not loaded).
        ``kv_transfer_bytes``: what a submit-time ``prefetch_kv`` moved,
        for the request's cost record. ``resume``: a migrated request's
        resume record (``_finish_migrated``, this package's or the JAX
        one's): its seed, its emitted tokens (pre-seeded, never
        re-emitted: admission prefills prompt + tokens as after a
        preemption, so the continuation is the undisturbed run's tail)
        and its speculation controller's state."""
        if not prompt:
            raise ValueError("empty prompt")
        if self.group is not None:
            for f, v, item in (("kv_source", kv_source, "9.13"),
                               ("kv_export", kv_export, "9.13"),
                               ("resume", resume, "9.14")):
                if v:
                    raise ValueError(
                        f"{f} under tp or pp is a later slice of the port "
                        f"(ROADMAP Queue A item {item})")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not isinstance(resume, dict):
            resume = None
        if resume is not None and resume.get("adapter"):
            # the continuation runs under the source's adapter, never on
            # base weights
            adapter = str(resume["adapter"])
        if resume is not None and resume.get("seed") is not None:
            # the position-keyed draws continue the source's stream only
            # under its seed
            seed = int(resume["seed"])
        if seed is None:
            seed = time.time_ns() % (1 << 31)
        req = BatchRequest(prompt=[int(t) for t in prompt],
                           max_new_tokens=int(max_new_tokens),
                           sampling=sampling or SamplingParams(),
                           eos_token_id=eos_token_id, stream_cb=stream_cb,
                           seed=int(seed),
                           kv_source=(kv_source if isinstance(kv_source, dict)
                                      else None),
                           kv_export=bool(kv_export),
                           adapter=str(adapter) if adapter else None)
        req._kv_transfer_bytes = int(kv_transfer_bytes or 0)
        if resume is not None and resume.get("tokens"):
            req.tokens = [int(t) for t in resume["tokens"]]
            if len(req.tokens) >= req.max_new_tokens:
                raise ValueError(
                    f"resume record carries {len(req.tokens)} emitted "
                    f"tokens >= max_new_tokens {req.max_new_tokens}: the "
                    "source should have completed, not migrated")
            state = resume.get("spec")
            if (state and self.spec_wave and self._spec_adaptive
                    and self.spec_gamma >= 1):
                # the request-owned policy state migrates; the throughput
                # EMAs start from this host's
                req._spec_ctl = self._seed_wave_ctl(
                    AdaptiveSpecController(self.spec_gamma))
                req._spec_ctl.load_state(state)
        if len(req.prompt) + req.max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({len(req.prompt)}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds max_seq {self.max_seq}")
        if req.adapter:
            # last: the pin is the one side effect, so no earlier raise
            # can leak a refcount
            self._pin_lora(req.adapter)
            self.metrics.inc("lora_requests")
        return req

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 100,
               sampling: Optional[SamplingParams] = None,
               eos_token_id: Optional[int] = None,
               stream_cb: Optional[Callable[[int], None]] = None,
               seed: Optional[int] = None, **kv) -> BatchRequest:
        """``kv``: ``make_request``'s ``kv_source``, ``kv_export``,
        ``kv_transfer_bytes``, ``resume`` and ``adapter``."""
        return self.submit_many([dict(
            prompt=prompt, max_new_tokens=max_new_tokens, sampling=sampling,
            eos_token_id=eos_token_id, stream_cb=stream_cb, seed=seed,
            **kv)])[0]

    def submit_many(self, specs: Sequence[dict]) -> List[BatchRequest]:
        """Validate and build every request of ``specs`` (keyword dicts
        of ``submit``) first — one bad spec raises and enqueues none, and
        drops the adapter pins its built siblings took — then enqueue
        them all in order."""
        reqs: List[BatchRequest] = []
        try:
            for spec in specs:
                reqs.append(self.make_request(**spec))
        except Exception:
            for r in reqs:
                self._release_lora(r)
            raise
        return self.enqueue(reqs)

    def enqueue(self, reqs: Sequence[BatchRequest]) -> List[BatchRequest]:
        """Enqueue built requests in order under one lock, with one wake
        of the scheduler."""
        reqs = list(reqs)
        if not reqs:
            return []
        if self._error is not None:   # the loop is gone: fail, not hang
            for req in reqs:
                self._fail_req(req, f"scheduler error: {self._error}")
            return reqs
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
        self.release_programs()
        if self._leader is not None:
            self._leader.stop("batcher_stop")   # and join the followers

    def rank_stats(self, pool_blocks: Optional[Sequence[int]] = None
                   ) -> List[dict]:
        """Every rank's launches, collectives, programs run and outputs
        digest, and with ``pool_blocks`` its shard of those pool blocks
        (``_stats``), the leader's first (one entry without tp)."""
        kw = {} if pool_blocks is None else {"pool_blocks": list(pool_blocks)}
        if self._leader is None:
            return [self._stats(**kw)]
        return self._leader.run("batcher_stats", kw,
                                lambda: self._stats(**kw))

    def reset_counts(self):
        """Zero the kernel launch and collective counts on every rank."""
        if self._leader is None:
            self._reset_counts()
        else:
            self._leader.run("reset_counts", {}, self._reset_counts)

    def stats(self) -> dict:
        out = {
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
            "decode_overlap": self.decode_overlap,
            "overlapped_dispatches": self._overlapped_dispatches,
            "speculative": self.speculative,
            "spec_accepted_tokens": self._spec_accepted,
            "spec_adaptive": (self._spec_ctl.stats()
                              if self._spec_ctl is not None else None),
            "spec_wave": self._spec_wave_stats(),
            "pool": self.pool.stats(),
            # the host KV tier and the prefix digests the master routes by
            "kvtier": (self.kvtier.stats()
                       if self.kvtier is not None else None),
            "prefix_digests": (self.kvtier.index.advertise()
                               if self.kvtier is not None else None),
            # the resident adapters the master's affinity routing reads
            "adapters": self.lora_stats(),
            "mesh": self.mesh_spec.axis_sizes(),
            **self.programs.stats(),
        }
        if self.group is not None:
            out["backend"] = self.group.backend
            out["ranks"] = self.group.world
            out["rank_param_bytes"] = self._rank_param_bytes
        return out

    def _spec_wave_stats(self) -> Optional[dict]:
        """Wave mode's view over the ACTIVE requests' controllers: the
        live width mix, not lifetime history."""
        if not self.spec_wave:
            return None
        ctls = [a._spec_ctl for a in self.active
                if a is not None and a._spec_ctl is not None]
        return {
            "dispatches": self._spec_wave_dispatches,
            "active_controllers": len(ctls),
            "drafting": sum(c.mode == "spec" for c in ctls),
            "plain": sum(c.mode == "plain" for c in ctls),
            "fallbacks": sum(c.fallbacks for c in ctls),
            "gamma_mean": (round(float(np.mean([c.gamma for c in ctls])),
                                 2) if ctls else None),
        }

    # ---- multi-LoRA adapters (models/lora.py) -------------------------

    def load_adapter(self, name: str, source: str) -> dict:
        """Make an adapter host-resident (the worker's ``POST
        /load_adapter``); its device slot is bound at the first admission
        that needs it. Idempotent for a resident name. Returns ``{name,
        rank, nbytes, evicted}``; ValueError on any problem (a bad
        source, a shape mismatch, a store full of pinned adapters; under
        tp, ROADMAP Queue A item 9.11; under pp, as the JAX batcher)."""
        if self.mesh_spec.pp > 1:
            raise ValueError(
                "LoRA serving does not support pp > 1 (as the JAX batcher: "
                "the pipelined programs hold no delta pack)")
        if self.group is not None:
            raise ValueError(
                "LoRA adapters under tp are not ported yet (ROADMAP Queue A "
                "item 9.11); load the model without a mesh")
        lora_mod.validate_base_model(self.cfg)
        with self._lora_lock:
            ad = self._lora_store.get(name)
            evicted: List[str] = []
            if ad is None:
                try:
                    ad = lora_mod.resolve(self.cfg, name, source,
                                          max_rank=self._lora_max_rank)
                    pinned = {n for n, c in self._lora_refs.items() if c}
                    evicted = self._lora_store.put(ad, pinned=pinned)
                except ValueError:
                    self.metrics.inc("lora_load_failures")
                    raise
                self._lora_gen[name] = self._lora_gen.get(name, 0) + 1
                self.metrics.inc("lora_loads")
                self.metrics.inc("lora_evictions", len(evicted))
                # a host-evicted adapter (refcount 0) loses its slot; no
                # row references it, so the slot's pack rows can wait for
                # the slot's next binding
                for i in range(1, len(self._lora_slot_names)):
                    if self._lora_slot_names[i] in evicted:
                        self._lora_slot_names[i] = None
            self._gauge_lora()
            return {"name": ad.name, "rank": ad.rank, "nbytes": ad.nbytes,
                    "evicted": evicted}

    def unload_adapter(self, name: str) -> bool:
        """Drop an adapter from the host store and its slot; ValueError
        while live requests reference it."""
        with self._lora_lock:
            if self._lora_refs.get(name, 0):
                raise ValueError(
                    f"adapter {name!r} has live requests; drain first")
            for i in range(1, len(self._lora_slot_names)):
                if self._lora_slot_names[i] == name:
                    self._lora_slot_names[i] = None
            dropped = self._lora_store.drop(name)
            self._gauge_lora()
            return dropped

    def lora_stats(self) -> dict:
        with self._lora_lock:
            return {
                "resident": sorted(self._lora_store.names()),
                "slotted": [n for n in self._lora_slot_names[1:] if n],
                "slots": len(self._lora_slot_names) - 1,
                "host": self._lora_store.stats(),
                "active_refs": {n: c for n, c in self._lora_refs.items()
                                if c},
            }

    def _gauge_lora(self):
        st = self._lora_store.stats()
        self.metrics.gauge("lora_host_bytes", st["bytes"])
        self.metrics.gauge("lora_host_adapters", st["adapters"])

    def _pin_lora(self, name: str):
        """The submit-time refcount: pins the adapter against host
        eviction (and its slot, once bound, against reuse) from the
        moment the request exists. ValueError when not resident."""
        with self._lora_lock:
            if self._lora_store.get(name) is None:
                raise ValueError(
                    f"unknown adapter {name!r} (POST /load_adapter first)")
            self._lora_refs[name] = self._lora_refs.get(name, 0) + 1

    def _release_lora(self, req: BatchRequest):
        """The exactly-once release at the terminal point (finished,
        failed, cancelled, migrated). The slot stays bound for reuse:
        only a new adapter's need reclaims it."""
        if not req.adapter or req._lora_released:
            return
        req._lora_released = True
        with self._lora_lock:
            n = self._lora_refs.get(req.adapter, 0)
            if n > 1:
                self._lora_refs[req.adapter] = n - 1
            else:
                self._lora_refs.pop(req.adapter, None)

    def _assign_lora_slot(self, name: str) -> int:
        """Bind an adapter to a device slot at admission prep: its slot
        if bound, else a free one, else the least recently used slot no
        request pins (ValueError when every slot is pinned). A new
        binding writes the adapter into that slot of the pack."""
        with self._lora_lock:
            ad = self._lora_store.get(name)
            if ad is None:
                raise ValueError(
                    f"adapter {name!r} evicted from the host store "
                    "before admission (DLI_LORA_HOST_MB)")
            names = self._lora_slot_names
            if name in names:
                s = names.index(name)
            else:
                free = [i for i in range(1, len(names)) if names[i] is None]
                if free:
                    s = free[0]
                else:
                    idle = [i for i in range(1, len(names))
                            if not self._lora_refs.get(names[i], 0)]
                    if not idle:
                        raise ValueError(
                            f"adapter {name!r}: all {len(names) - 1} "
                            "device adapter slots are pinned by live "
                            "requests (DLI_LORA_SLOTS)")
                    s = min(idle, key=lambda i: self._lora_last_use.get(
                        names[i], 0))
                    self.metrics.inc("lora_evictions")
                names[s] = name
                self._write_lora_slot(s, ad)
            self._lora_seq += 1
            self._lora_last_use[name] = self._lora_seq
            return s

    def _write_lora_slot(self, s: int, ad):
        """Slot ``s`` of the device pack rewritten in place with ``ad``'s
        rows (``models.lora.slot_arrays``: the JAX ``build_pack``'s
        values), one copy per target and factor. The pack is allocated
        once, at the first binding, at (slots + 1, max_rank) per target:
        the captured programs read its addresses. Runs on the scheduler
        thread between programs, after the last chunk's sync."""
        cfg, rmax = self.cfg, self._lora_max_rank
        if self._lora_pack is None:
            S, L = len(self._lora_slot_names), cfg.num_layers
            self._lora_pack = {}
            for t in lora_mod.lora_targets(cfg):
                din, dout = lora_mod.target_dims(cfg, t)
                self._lora_pack[t] = {
                    "a": torch.zeros((L, S, din, rmax), dtype=torch.float32,
                                     device=self.device),
                    "b": torch.zeros((L, S, rmax, dout), dtype=torch.float32,
                                     device=self.device)}
        for t, p in self._lora_pack.items():
            rows = [lora_mod.slot_arrays(cfg, ad, t, li, rmax)
                    for li in range(cfg.num_layers)]
            for j, k in enumerate(("a", "b")):
                p[k][:, s].copy_(torch.from_numpy(
                    np.stack([r[j] for r in rows])))

    # ---- device programs ----------------------------------------------

    def _device_program(self, kind: str, a: dict):
        """Run device program ``kind`` ("admit", "decode" or "spec") on
        host inputs ``a`` here and, under tp, on every follower first (the
        JAX batcher's ``program_hook``): the followers get the full
        inputs, the decode chunk sizes their buffers must hold, and for a
        speculative chunk the drafting history."""
        if self._leader is None:
            return self._run_program(kind, a)
        payload = dict(a, chunks=tuple(self.DECODE_CHUNKS),
                       fused_env=os.environ.get("DLI_FUSED_DECODE"))
        if kind == "spec":
            payload["hist"] = self._hist
        return self._leader.run(
            "batcher_program", {"kind": kind, "a": payload},
            lambda: self._run_program(kind, a))

    def _spec_gammas(self) -> List[int]:
        """The static widths a speculative chunk can take: spec_gamma, and
        without wave mode the global controller's halvings."""
        if not (self.speculative and self.spec_gamma >= 1):
            return []
        gs = {self.spec_gamma}
        if not self.spec_wave:
            g = self.spec_gamma
            while g > 2:
                g = max(2, g // 2)
                gs.add(g)
        return sorted(gs)

    def _spec_inputs(self, k: int, gamma: int) -> dict:
        """A speculative chunk's host inputs with every slot inactive."""
        return dict(self._chunk_inputs(k), gamma=gamma,
                    gammas=np.zeros((self.slots,), np.int32))

    @torch.inference_mode()
    def warm_decode_programs(self) -> int:
        """Capture the decode program of the current route, and with
        speculation the speculative chunk's at each static width, ahead
        of traffic (the JAX batcher's ``warm_decode_programs``): one real
        step with every slot inactive, whose writes land in the reserved
        dummy block (or in the side buffers alone) and whose outputs are
        dropped, then the capture. Returns the programs captured: 0 with
        graphs off (under tp too: every program runs eagerly) or already
        warm."""
        if not self._capture:
            return 0
        n = 0
        step = self._decode_program()
        if not step.captured:
            self._bufs.load(self._chunk_inputs(1))
            step()
            n += 1
        for g in self._spec_gammas():
            bufs, prog = self._spec_program(g)
            if not prog.captured:
                bufs.load(self._spec_inputs(1, g), self._hist)
                prog()
                n += 1
        return n

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
                          start: int = 0, progress=None) -> int:
        """Pull the arena-missing chain digests of ``prompt``'s blocks
        ``[start, limit)`` from the peer at ``url`` into this arena. Any
        failure (transport, corrupt frame, blocks the peer lacks, shape
        drift) degrades to recompute. Returns the wire bytes stored.
        Single-flight: concurrent calls for one (peer, model) coalesce; the
        first leads and fetches the union of every caller's missing
        digests, the others wait for it and find their blocks in the
        arena, so each digest crosses the wire once. ``progress(stream)``,
        if given, runs on the leader's thread after each block lands (the
        receive-overlapped restore's consumer)."""
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
                total += self._wire_fetch(url, model, batch,
                                          progress=progress)
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

    def _wire_fetch(self, url, model, want, progress=None) -> int:
        """One transfer of ``want`` digests (the single-flight leader's
        round), each block checked and put in the arena as its frame
        decodes (``kvwire.FetchStream``: the socket's next frames arrive
        meanwhile), ``progress(stream)`` called after each. A fault
        mid-stream keeps the blocks that landed; the rest recomputes."""
        expect = [((lf.shape[0],) + tuple(lf.shape[2:]),
                   kvq.host_dtype(lf.dtype)) for lf in self.paged.leaves()]
        w0 = time.perf_counter()
        blocks = bytes_in = 0
        try:
            stream = self._get_kv_fetcher().fetch_stream(url, model, want)
            for d, obj in stream:
                if self._admit_fetched(d, obj, expect):
                    blocks += 1
                    bytes_in += kvwire.stored_nbytes(obj)
                    if progress is not None:
                        progress(stream)
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
        ``kv_source``: pull its missing block digests from the peer into
        the arena. With the receive overlap on (``DLI_KV_WIRE_OVERLAP``,
        the default) runs of about ``RESTORE_RUN`` landed blocks restore
        into the pool in place (``_restore_from_arena``) while the
        receiver thread pulls later frames off the socket, so the scatter
        of block N overlaps the receive of block N+1; the share of the
        transfer's wall time spent restoring meanwhile is the
        ``kv_restore_overlap_ratio`` gauge. Off, the whole transfer lands
        first and admission restores it after. Returns the (possibly
        extended) (prefix_blocks, cached). The worker never takes this
        path (it prefetches on its handler thread, ``prefetch_kv``, and
        submits without ``kv_source``); it serves direct batcher users,
        whose ``submit(kv_source=...)`` the JAX batcher accepts too."""
        src = req.kv_source
        if src is None or req._peer_fetch_done:
            return prefix_blocks, cached
        url = src.get("url")
        if not url:
            req._peer_fetch_done = True
            return prefix_blocks, cached
        bs = self.block_size
        start, limit = cached // bs, (n - 1) // bs
        if start >= limit:
            return prefix_blocks, cached
        digs = self.kvtier.block_digests(prompt[:limit * bs])
        if all(self.kvtier.arena.peek(d) for d in digs[start:limit]):
            return prefix_blocks, cached   # nothing missing: no transfer
        req._peer_fetch_done = True
        state = {"pb": prefix_blocks, "cached": cached, "arrived": 0,
                 "overlap_s": 0.0}

        def scatter_ready(stream):
            state["arrived"] += 1
            if (state["arrived"] < self.RESTORE_RUN
                    and not stream.receiving_done):
                return
            state["arrived"] = 0
            t0 = time.perf_counter()
            receiving = not stream.receiving_done
            state["pb"], state["cached"] = self._restore_from_arena(
                prompt, n, state["pb"], state["cached"])
            if receiving:
                state["overlap_s"] += time.perf_counter() - t0

        w0 = time.perf_counter()
        got = self._fetch_into_arena(
            url, str(src.get("model") or ""), prompt, limit, start=start,
            progress=scatter_ready if self._wire_overlap else None)
        req._kv_transfer_bytes += got
        wall = time.perf_counter() - w0
        if got and self._wire_overlap and wall > 0:
            self.metrics.gauge("kv_restore_overlap_ratio",
                               min(1.0, state["overlap_s"] / wall))
        return state["pb"], state["cached"]

    def _export_request_kv(self, req, seq=None, n_ctx=None):
        """Park a request's KV in the arena under its token-chain digests,
        the blocks a peer's ``/kv_fetch`` asks for, while the request
        still owns its blocks: at finish of a ``kv_export`` pass ``seq``
        is the prompt, whose KV the pass wrote in full; for a migration
        (``_service_migrations``) ``seq`` is prompt + emitted tokens and
        ``n_ctx`` the slot's context length, so only positions whose KV
        is on the device export (the last emitted token's KV would come
        with the next chunk: the destination prefills it). Blocks the
        arena holds already are skipped."""
        if req.error or not req._blocks:
            return
        bs = self.block_size
        seq = list(req.prompt) if seq is None else list(seq)
        n = len(seq) if n_ctx is None else min(int(n_ctx), len(seq))
        n_full = min(n // bs, len(req._blocks))
        if n_full <= 0:
            return
        digs = self.kvtier.block_digests(seq[:n_full * bs])
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

    def _shared_wave_blocks(self, wave: List[dict], prompt: List[int],
                            ns=None) -> int:
        """Longest common full-block prefix (in blocks) between `prompt`
        and any prompt of the radix namespace ``ns`` already in the
        admission wave."""
        best = 0
        for m in wave:
            if m["ns"] != ns:
                continue
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
        generation resumes where it left off, nothing is re-emitted. An
        adapter request binds its adapter to a device slot first
        (ValueError when every slot is pinned: the request fails, it is
        never served on base weights)."""
        if req.adapter:
            req._lora_slot = self._assign_lora_slot(req.adapter)
        self._admitting = req
        try:
            return self._prep_admit_blocks(req)
        finally:
            self._admitting = None

    def _kv_namespace(self, req: BatchRequest):
        """The radix namespace of ``req``'s KV: None (the base tree) for
        the base model, else its adapter's name and load generation, so a
        reloaded name never matches the blocks of its earlier weights."""
        if not req.adapter:
            return None
        return (req.adapter, self._lora_gen.get(req.adapter, 0))

    def _prep_admit_blocks(self, req: BatchRequest) -> Optional[dict]:
        bs = self.block_size
        prompt = req.prompt + req.tokens
        n = len(prompt)
        # leave >= 1 token for the tail: prefill must produce the last
        # token's logits
        ns = self._kv_namespace(req)
        prefix_blocks, cached = self.pool.match_prefix(prompt[:n - 1], ns)
        if self.kvtier is not None and ns is None:
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
                "prefix_blocks": prefix_blocks, "tail_alloc": tail_alloc,
                "ns": ns}

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
                    and (self._shared_wave_blocks(wave, prep["prompt"],
                                                  prep["ns"])
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
        pp = self.mesh_spec.pp   # wave rows microbatch over the stages
        b = -(-b // pp) * pp
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
        aids = np.zeros((b,), np.int32)
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
            aids[j] = req._lora_slot
        if aids.any():
            # the key's presence selects the lora program: a base-only
            # wave runs the base one, untouched
            a["aids"] = aids
        w0 = time.perf_counter()
        for m in members:
            if m["req"].admitted_at is None:
                m["req"].admitted_at = w0
        try:
            first = self._device_program("admit", a)
        except Exception as e:
            # the wave's requests left the queue and hold no slot yet:
            # fail them here, before the loop fails the rest
            for m in members:
                self._fail_req(m["req"], f"scheduler error: {e}")
            raise
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
                                    tail_real[:n_full - skip], skip, m["ns"])

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
        if self._hist is not None:
            known = m["prompt"][: self.max_seq + 1]
            self._hist[slot, :len(known)] = known
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
        self._emit(req, first)
        if self._hist is not None and req.tokens:
            # the admission's sampled token extends the history
            self._hist[slot, min(n, self.max_seq)] = req.tokens[-1]
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
        if req.kv_export and self.kvtier is not None and not req.adapter:
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
            "spec_accepted_tokens": req._spec_acc,
            "spec_rejected_tokens": req._spec_rej,
            "spec_drafted_tokens": req._spec_drafted,
        }

    def _observe_finished(self, req: BatchRequest):
        self._release_lora(req)   # every terminal outcome comes here
        m = self.metrics
        m.inc("batcher_requests_migrated" if req._migrated
              else "batcher_requests_failed" if req.error
              else "batcher_requests_completed")
        end = req.finished_at or time.perf_counter()
        if not req._migrated:
            # a handed-off request's span is not a served request: the
            # destination observes the real one
            m.observe("batcher_e2e_latency", end - req.submitted_at)
            if req.first_token_at is not None:
                m.observe("batcher_ttft",
                          req.first_token_at - req.submitted_at)
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
        # migrations first: a flagged slot must not ride another chunk
        # (its export would go stale), and its slot and blocks are this
        # step's admission capacity
        self._service_migrations()
        # drop cancelled slots next: frees their blocks for admission
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
            a["aids"][i] = req._lora_slot
        if self.speculative:
            return self._step_speculative(active, a)
        if self._overlap_eligible(active, k):
            return self._step_overlapped(active, a, k)
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
                "eos": np.full((r,), -1, np.int32),
                "aids": np.zeros((r,), np.int32)}

    def _dispatch_plain_chunk(self, active, a: dict) -> int:
        """One K-token decode chunk: run, sync, emit, finish dead slots.
        Returns tokens emitted."""
        k = int(a["k"])
        w0 = time.perf_counter()
        toks, emits = self._device_program("decode", a)
        self._step_count += 1
        self._chunk_sizes.add(k)
        self.metrics.observe("batcher_decode_chunk", time.perf_counter() - w0)
        # the drafting history stays current through plain chunks (the
        # controllers interleave them)
        self._apply_plain_hist(toks, emits, a["cl"])
        return self._emit_chunk_outputs(active, toks, emits, k, a["budget"])

    def _emit_chunk_outputs(self, active, toks, emits, passes: int,
                            budget=None) -> int:
        """Emit each slot's tokens, advance its context, finish slots that
        hit eos (stopped before their budget; an overlapped pair is
        eos-free and passes no budget) or their token limit."""
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
            hit_eos = budget is not None and cnt < int(budget[i])
            if hit_eos or len(req.tokens) >= req.max_new_tokens:
                self._finish_slot(i)
        # amortization: emitted tokens per weight-streaming pass (one pass
        # per decode iteration), the number continuous batching raises
        self.metrics.gauge("decode_tokens_per_weight_pass",
                           emitted / passes if passes else 0.0)
        self.metrics.inc("batcher_weight_passes", passes)
        self.metrics.inc("batcher_tokens_emitted", emitted)
        return emitted


    # ---- overlapped dispatch ------------------------------------------

    def _overlap_eligible(self, active, k: int) -> bool:
        """A chunk pair can run back to back with no host decision between
        them: overlap on, nothing queued, and every active slot provably
        emits ``k`` tokens in each (no eos to look for, no stream callback
        wanting its tokens per chunk, a budget covering both), with
        growth blocks for 2k allocated."""
        if not self.decode_overlap:
            return False
        with self._lock:
            if self.queue:
                return False
        for i in active:
            req = self.active[i]
            if (req.eos_token_id is not None or req.stream_cb is not None
                    or req.max_new_tokens - len(req.tokens) < 2 * k):
                return False
        # growth may fail at the pool's or the table's edge: the step then
        # runs one chunk (blocks already granted back the next one)
        return all(self._ensure_growth(i, 2 * k) for i in active)

    def _step_overlapped(self, active, a: dict, k: int) -> int:
        """Chunk A, then chunk B continued from A's state on the device
        (A's last tokens feed B without visiting the host), and one sync
        for the pair: A's outputs copy out while B is queued. The 2k
        growth ran after the step built ``a``, whose table is the
        batcher's own array, so both chunks load the refreshed tables."""
        w0 = time.perf_counter()
        out_a = self._launch_decode(a)
        out_b = self._launch_decode(a, cont=True)
        both = torch.cat([out_a, out_b], dim=1).cpu().numpy()   # one sync
        self._step_count += 2
        self._chunk_sizes.add(k)
        self._overlapped_dispatches += 1
        self.metrics.inc("batcher_overlapped_dispatches")
        dt = time.perf_counter() - w0
        self.metrics.observe("batcher_decode_chunk", dt / 2)
        self.metrics.observe("batcher_decode_chunk", dt / 2)
        toks, emits = both[0], both[1].astype(bool)
        self._apply_plain_hist(toks, emits, a["cl"])
        self._emit_chunk_outputs(active, toks, emits, 2 * k)
        return len([x for x in self.active if x is not None])

    # ---- speculation --------------------------------------------------

    def _apply_spec_hist(self, toks, keeps, cl):
        """Append a speculative chunk's kept tokens ([K,R,G+1], keeps
        [K,R]) to the host history, after each slot's ``cl[r] + 1``
        known tokens."""
        if self._hist is None:
            return
        for r in range(keeps.shape[1]):
            pos = int(cl[r]) + 1
            for t in range(keeps.shape[0]):
                for tok in toks[t, r, :int(keeps[t, r])]:
                    if pos <= self.max_seq:
                        self._hist[r, pos] = int(tok)
                    pos += 1

    def _apply_plain_hist(self, toks, emits, cl):
        """A plain chunk's tokens into the history: the speculative case
        at width one (``emits`` a 0/1 keep column)."""
        if self._hist is None:
            return
        self._apply_spec_hist(np.asarray(toks)[:, :, None],
                              np.asarray(emits).astype(np.int32), cl)

    def _emit_spec_outputs(self, active, toks, keeps, eos_seen, k_it: int,
                           gammas) -> dict:
        """Emit each slot's kept tokens ([K,R,G+1] outputs), advance its
        context and cost ledger, finish it on the device's cumulative eos
        flag or an exhausted budget (a slot may emit less than its budget
        when its drafts miss). Returns {slot: (req, emitted, live
        iterations, drafted)}."""
        out = {}
        for i in active:
            req = self.active[i]
            cnt = int(keeps[:, i].sum())
            for t in range(keeps.shape[0]):
                for tok in toks[t, i, :int(keeps[t, i])]:
                    self._emit(req, int(tok))
            live = int((keeps[:, i] > 0).sum())
            acc_i = cnt - live
            drafted_i = int(gammas[i]) * live
            self._spec_accepted += acc_i
            req._weight_passes += k_it
            req._spec_acc += acc_i
            req._spec_rej += max(0, drafted_i - acc_i)
            req._spec_drafted += drafted_i
            self.context_lens[i] += cnt
            out[i] = (req, cnt, live, drafted_i)
            if bool(eos_seen[-1, i]) or len(req.tokens) >= req.max_new_tokens:
                self._finish_slot(i)
        return out

    def _spec_captured(self, gamma: int) -> bool:
        """Whether the speculative chunk at ``gamma`` runs a capture next
        (its time then is not decode time, for the controllers)."""
        _, prog = self._spec_program(gamma)
        return prog.graphs is not None and not prog.captured

    def _plain_captured(self) -> bool:
        prog = self._decode_program()
        return prog.graphs is not None and not prog.captured

    def _spec_chunk(self, active, a: dict, gamma: int, gammas):
        """One speculative chunk covering ``a``'s K-token budget in
        ceil(K / (gamma+1)) iterations: run, sync, append the history,
        emit. Block growth covers K tokens: kept writes never pass the
        budget, and rejected entries scatter to the dummy block. Returns
        (per-slot results, k_it, elapsed s)."""
        k_it = -(-int(a["k"]) // (gamma + 1))
        args = dict(a, k=k_it, gamma=gamma, gammas=gammas)
        w0 = time.perf_counter()
        toks, keeps, eos_seen = self._device_program("spec", args)
        self._step_count += 1
        dt = time.perf_counter() - w0
        self.metrics.observe("batcher_decode_chunk", dt)
        self._apply_spec_hist(toks, keeps, a["cl"])
        per = self._emit_spec_outputs(active, toks, keeps, eos_seen, k_it,
                                      gammas)
        emitted = sum(cnt for (_, cnt, _, _) in per.values())
        m = self.metrics
        # a verify iteration streams the weights once, however wide
        m.gauge("decode_tokens_per_weight_pass",
                emitted / k_it if k_it else 0.0)
        m.inc("batcher_weight_passes", k_it)
        m.inc("batcher_tokens_emitted", emitted)
        return per, k_it, dt

    def _step_speculative(self, active, a: dict) -> int:
        """A speculative chunk in place of the plain one (the JAX batcher's
        ``_step_speculative``). Wave mode: per-slot widths
        (``_step_spec_wave``). Off: one global controller picks one gamma
        for the wave, 0 running the whole chunk plain; every chunk's
        acceptance, tokens and time feed it back."""
        if self.spec_wave:
            return self._step_spec_wave(active, a)
        ctl = self._spec_ctl
        gamma = ctl.choose() if ctl is not None else self.spec_gamma
        m = self.metrics
        if ctl is not None:
            m.gauge("spec_mode", 1.0 if gamma else 0.0)
            m.gauge("spec_gamma_current", float(gamma or ctl.gamma))
            acc = ctl.acceptance()
            if acc is not None:
                m.gauge("spec_acceptance_rate", acc)
        if gamma <= 0:
            compiled = self._plain_captured()
            w0 = time.perf_counter()
            emitted = self._dispatch_plain_chunk(active, a)
            if ctl is not None:
                ctl.record("plain", emitted=emitted,
                           elapsed_s=time.perf_counter() - w0,
                           compiled=compiled)
            return len([x for x in self.active if x is not None])
        compiled = self._spec_captured(gamma)
        per, _, dt = self._spec_chunk(
            active, a, gamma, np.full((self.slots,), gamma, np.int32))
        emitted = sum(cnt for (_, cnt, _, _) in per.values())
        live_iters = sum(live for (_, _, live, _) in per.values())
        if ctl is not None:
            ctl.record("spec", emitted=emitted, elapsed_s=dt,
                       drafted=gamma * live_iters,
                       accepted=emitted - live_iters, compiled=compiled)
            if ctl.fallbacks:
                m.gauge("spec_fallbacks", float(ctl.fallbacks))
        return len([x for x in self.active if x is not None])

    def _seed_wave_ctl(self, ctl):
        """A fresh per-request controller seeded from the shared
        arbitration state (the throughput EMAs and probe clocks measure
        the host, not the request); it starts in plain mode when those
        already say drafting loses."""
        sh = self._wave_shared
        ctl.spec_tps = sh["spec_tps"]
        ctl.plain_tps = sh["plain_tps"]
        ctl._since_plain_probe = sh["since_plain_probe"]
        ctl._since_probe = sh["since_probe"]
        if (ctl.spec_tps is not None and ctl.plain_tps is not None
                and ctl.spec_tps < ctl.plain_tps * ctl.hysteresis):
            ctl.mode = "plain"
        return ctl

    def _sync_wave_shared(self, ctl):
        """One controller's arbitration state back to the shared store
        (the last writer wins: active controllers tick together)."""
        sh = self._wave_shared
        sh["spec_tps"] = ctl.spec_tps
        sh["plain_tps"] = ctl.plain_tps
        sh["since_plain_probe"] = ctl._since_plain_probe
        sh["since_probe"] = ctl._since_probe

    def _step_spec_wave(self, active, a: dict) -> int:
        """Wave-level speculation: one verify pass serves the active wave
        with per-slot widths as data, each from the request's own
        controller; a width-0 slot rides the pass as plain decode (one
        exact token per iteration). Only when every slot chooses 0 does
        the step run a plain chunk. The program's static width stays
        ``spec_gamma``: width mixes change data, never the capture."""
        m = self.metrics
        g_max = self.spec_gamma
        gammas = np.zeros((self.slots,), np.int32)
        for i in active:
            req = self.active[i]
            if self._spec_adaptive and g_max >= 1:
                if req._spec_ctl is None:
                    req._spec_ctl = self._seed_wave_ctl(
                        AdaptiveSpecController(g_max))
                gammas[i] = req._spec_ctl.choose()
            else:
                gammas[i] = max(0, g_max)
        drafting = [i for i in active if gammas[i] > 0]
        riding = [i for i in active if gammas[i] == 0]
        m.gauge("spec_wave_drafting_slots", float(len(drafting)))
        m.gauge("spec_wave_gamma_mean",
                float(np.mean([gammas[i] for i in active])))
        m.gauge("spec_mode", 1.0 if drafting else 0.0)
        if not drafting:
            compiled = self._plain_captured()
            reqs = {i: self.active[i] for i in active}
            before = {i: len(r.tokens) for i, r in reqs.items()}
            w0 = time.perf_counter()
            self._dispatch_plain_chunk(active, a)
            dt = time.perf_counter() - w0
            for i, req in reqs.items():
                if req._spec_ctl is not None:
                    req._spec_ctl.record(
                        "plain", emitted=len(req.tokens) - before[i],
                        elapsed_s=dt, compiled=compiled)
                    self._sync_wave_shared(req._spec_ctl)
            return len([x for x in self.active if x is not None])
        compiled = self._spec_captured(g_max)
        per, _, dt = self._spec_chunk(active, a, g_max, gammas)
        self._spec_wave_dispatches += 1
        m.inc("spec_wave_dispatches")
        emitted = sum(cnt for (_, cnt, _, _) in per.values())
        drafted_total = sum(d for (_, _, _, d) in per.values())
        accepted_total = emitted - sum(live for (_, _, live, _)
                                       in per.values())
        for i, (req, cnt, live, drafted_i) in per.items():
            if req._spec_ctl is None:
                continue
            if int(gammas[i]) > 0:
                req._spec_ctl.record("spec", emitted=cnt, elapsed_s=dt,
                                     drafted=drafted_i,
                                     accepted=cnt - live,
                                     compiled=compiled)
            else:
                req._spec_ctl.record("plain", emitted=cnt, elapsed_s=dt,
                                     compiled=compiled)
            self._sync_wave_shared(req._spec_ctl)
        m.inc("spec_wave_drafted_tokens", drafted_total)
        m.inc("spec_wave_accepted_tokens", accepted_total)
        m.inc("spec_wave_plain_rides", len(riding))
        if drafted_total:
            m.gauge("spec_acceptance_rate", accepted_total / drafted_total)
        return len([x for x in self.active if x is not None])

    # ---- live migration -----------------------------------------------

    def migrate_out(self, req: BatchRequest,
                    timeout: float = 10.0) -> Optional[dict]:
        """Snapshot and evict one request (the worker's ``POST
        /migrate_out``): the scheduler exports its computed KV into the
        host arena and hands back a resume record at its next step
        boundary. Blocks until the request is terminal; returns the
        record, or None when it completed or failed first (the caller
        answers 409 and the result stands) or the scheduler did not get
        to it within ``timeout``. ValueError under tp (ROADMAP Queue A
        item 9.14)."""
        if self.group is not None:
            raise ValueError(
                "migration under tp is a later slice of the port (ROADMAP "
                "Queue A item 9.14)")
        req._migrate_requested = True
        self._work.set()
        if not req.done.wait(timeout):
            req._migrate_requested = False
            return None
        return req.resume_record if req._migrated else None

    def _service_migrations(self):
        """At the step boundary: a flagged active slot exports its KV
        through its context length (``_export_request_kv``) and frees like
        a preemption (the radix keeps its blocks warm, the arena holds
        the export for a peer's /kv_fetch); a flagged queued request hands
        off its record alone."""
        pending = any(a is not None and a._migrate_requested
                      for a in self.active)
        with self._lock:
            queued = [r for r in self.queue if r._migrate_requested]
            for r in queued:
                self.queue.remove(r)
        for req in queued:
            self._finish_migrated(req)
        if not pending:
            return
        for slot in range(self.slots):
            req = self.active[slot]
            if req is None or not req._migrate_requested:
                continue
            if self.kvtier is not None and not req.adapter:
                try:
                    self._export_request_kv(
                        req, seq=req.prompt + req.tokens,
                        n_ctx=int(self.context_lens[slot]))
                except Exception:
                    log.warning("migration KV export failed for slot %d; "
                                "the destination will recompute", slot,
                                exc_info=True)
            self.pool.release(req._blocks)
            req._blocks = []
            self.active[slot] = None
            self.block_tables[slot, :] = self._dummy
            self.context_lens[slot] = 0
            if slot in self._admit_order:
                self._admit_order.remove(slot)
            self._finish_migrated(req)

    def _finish_migrated(self, req: BatchRequest):
        """The terminal "handed off" outcome: the resume record (the JAX
        batcher's keys) holds what a destination needs to continue the
        stream exactly: the emitted tokens (it re-emits none), the seed
        of the position-keyed draws, the budget and eos, and the
        speculation controller's state."""
        req.resume_record = {
            "prompt_tokens": list(req.prompt),
            "tokens": list(req.tokens),
            "seed": int(req.seed),
            "steps": len(req.tokens),
            "max_new_tokens": int(req.max_new_tokens),
            "eos_token_id": req.eos_token_id,
            "spec": (req._spec_ctl.export_state()
                     if req._spec_ctl is not None else None),
            "adapter": req.adapter,
        }
        req._migrated = True
        req.error = "migrated"
        req.finished_at = time.perf_counter()
        self._observe_finished(req)
        req.done.set()

    # ---- background loop ----------------------------------------------

    def _loop(self):
        while not self._stop.is_set():
            try:
                busy = self.step()
            except Exception as e:   # fail every waiter fast, then stop
                self._error = f"{type(e).__name__}: {e}"
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
                  "ds", "alive", "cl0", "aids")

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
                       ("budget", "budget"), ("eos", "eos"), ("ds", "ds"),
                       ("aids", "aids")):
            h[f][:] = a[key]
        h["alive"][:] = np.asarray(a["budget"]) > 0
        ints[-1] = 0
        floats = self.host_floats.numpy()
        floats[:r] = a["temps"]
        floats[r:] = a["tps"]
        self.ints.copy_(self.host_ints, non_blocking=True)
        self.floats.copy_(self.host_floats, non_blocking=True)

    def advance(self):
        """The next chunk of an overlapped pair, on the device alone: every
        live slot of the last chunk emitted its whole budget (the pair's
        eligibility), so it continues from the last chunk's context and
        token with the same budget, its step counter ``budget`` further
        on. The staging copies are left alone (the last chunk's may still
        be queued)."""
        s = self.state
        s.steps0.add_(s.budget)
        s.cl0.copy_(s.cl)
        s.alive.copy_(s.budget > 0)
        s.t.zero_()


class _SpecBuffers:
    """The speculative chunk's static device state (``SpecChunkState``)
    for R slots, tables of MB blocks, histories of H tokens, K iterations
    of width gamma: a packed int32 buffer [bt | hist | cur | cl | cl0 |
    seeds | steps0 | tks | budget | eos | ds | gammas | alive | emitted |
    eos_seen | t] and f32 [temps | tps], staged through pinned copies as
    ``_ChunkBuffers`` does; the side buffers, entry positions and kept
    mask; the outputs; and, when ``pool_tokens`` > 0, the once-per-chunk
    pool gather [L, R, pool_tokens, Hkv, hd]."""

    ROW_FIELDS = ("cur", "cl", "cl0", "seeds", "steps0", "tks", "budget",
                  "eos", "ds", "gammas", "alive", "emitted", "eos_seen",
                  "aids")

    def __init__(self, rows: int, mb: int, hh: int, kmax: int, gamma: int,
                 cfg, num_layers: int, kv_heads: int, dtype,
                 device: torch.device, pool_tokens: int = 0):
        self.rows, self.mb, self.hh = rows, mb, hh
        g1 = gamma + 1
        e = kmax * g1
        hist_at = rows * mb
        rows_at = hist_at + rows * (hh + 1)
        n = rows_at + len(self.ROW_FIELDS) * rows + 1
        pin = device.type == "cuda"
        self.host_ints = torch.zeros(n, dtype=torch.int32, pin_memory=pin)
        self.host_floats = torch.empty(2 * rows, dtype=torch.float32,
                                       pin_memory=pin)
        self.ints = torch.zeros(n, dtype=torch.int32, device=device)
        self.floats = torch.empty(2 * rows, dtype=torch.float32,
                                  device=device)
        at = {f: rows_at + rows * i for i, f in enumerate(self.ROW_FIELDS)}
        side = (num_layers, rows, e, kv_heads, cfg.head_dim)
        pool = None
        if pool_tokens:
            pool = (num_layers, rows, pool_tokens, kv_heads,
                    cfg.head_dim)
        self.state = SpecChunkState(
            bt=self.ints[:hist_at].view(rows, mb),
            hist=self.ints[hist_at:rows_at].view(rows, hh + 1),
            **{f: self.ints[o:o + rows] for f, o in at.items()},
            t=self.ints[n - 1:], temps=self.floats[:rows],
            tps=self.floats[rows:],
            side_k=torch.zeros(side, dtype=dtype, device=device),
            side_v=torch.zeros(side, dtype=dtype, device=device),
            side_pos=torch.zeros((rows, e), dtype=torch.int64,
                                 device=device),
            acc_mask=torch.zeros((rows, e), dtype=torch.bool,
                                 device=device),
            toks=torch.zeros((kmax, rows, g1), dtype=torch.int64,
                             device=device),
            keeps=torch.zeros((kmax, rows), dtype=torch.int64,
                              device=device),
            eos_out=torch.zeros((kmax, rows), dtype=torch.bool,
                                device=device),
            pool_k=(None if pool is None else
                    torch.zeros(pool, dtype=dtype, device=device)),
            pool_v=(None if pool is None else
                    torch.zeros(pool, dtype=dtype, device=device)))
        ints = self.host_ints.numpy()
        self._bt = ints[:hist_at].reshape(rows, mb)
        self._hist = ints[hist_at:rows_at].reshape(rows, hh + 1)
        self._host = {f: ints[o:o + rows] for f, o in at.items()}

    def load(self, a: dict, hist: np.ndarray):
        """One chunk's inputs (``ContinuousBatcher._spec_inputs``' keys)
        and the host history [R, H]; every slot's state reset (alive while
        it has budget, nothing emitted, no side entry kept)."""
        self._bt[:] = np.asarray(a["bt"])
        self._hist[:, :-1] = hist
        h = self._host
        for f, key in (("cur", "tokens"), ("cl", "cl"), ("cl0", "cl"),
                       ("seeds", "seeds"), ("steps0", "steps"),
                       ("tks", "tks"), ("budget", "budget"), ("eos", "eos"),
                       ("ds", "ds"), ("gammas", "gammas"), ("aids", "aids")):
            h[f][:] = a[key]
        h["alive"][:] = np.asarray(a["budget"]) > 0
        h["emitted"][:] = 0
        h["eos_seen"][:] = 0
        self.host_ints.numpy()[-1] = 0
        floats = self.host_floats.numpy()
        floats[:self.rows] = a["temps"]
        floats[self.rows:] = a["tps"]
        self.ints.copy_(self.host_ints, non_blocking=True)
        self.floats.copy_(self.host_floats, non_blocking=True)
        self.state.acc_mask.zero_()
        self.state.side_pos.zero_()
