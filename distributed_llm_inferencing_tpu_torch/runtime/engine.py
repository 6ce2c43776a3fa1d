"""InferenceEngine: bucketed prefill, token-by-token decode, sampling.

Port of the reference's ``runtime/engine.py`` engine mode for one model on
one device:

- **prefill**: one forward over a right-padded prompt block whose length
  is rounded up to a bucket (``_bucket``); the last real logit of each
  sequence is gathered before the head.
- **decode**: one step per token over the dense cache, updated in
  place, with sampling on the device from counter-based streams keyed on
  (request seed, row, step) (ops/sampling.py). The step is a decode
  program (runtime/graphs.py, the reference's ``_decode_fns``): captured
  as a CUDA graph once per (batch size, ``SamplingParams``) and replayed
  per token, or run eagerly on the same buffers — on the CPU, with
  ``DLI_CUDA_GRAPHS=0``, and under tp, whose gloo collectives cannot be
  captured (capture over NCCL is a later slice). The step works on a
  persistent per-batch-size state (``_Rows``: the dense cache, the token
  fed next, the row seeds, the step counter, the request's tokens), kept
  for ``ROWS_KEPT`` batch sizes and reset by each request's prefill,
  since a graph holds addresses. Prefill and ``teacher_forced`` run
  eagerly.
- **host syncs**: tokens stay on the device. With no eos stop and no
  ``stream_cb`` the host syncs once per request; with either, once per
  decode chunk (``DECODE_CHUNKS``, capped at ``STREAM_CHUNK_MAX``), which
  is when it must see tokens — the reference's schedule.
- **streaming**: ``stream_cb(step, tokens)`` fires with the prefill's
  tokens right after prefill (step 0), then once per decode step as each
  chunk lands; a finished row's entry is None.
- **speculation** (``generate(speculative="ngram", spec_gamma=g)``, one
  sequence): prompt lookup drafts ``g`` tokens on the host between verify
  steps (ops/speculative.py ``propose_ngram``), and the verify step
  scores them in one forward and keeps the agreeing prefix (1 to g + 1
  tokens per weight pass, one host sync each). The verify step is a
  decode program like the plain step, captured per (g,
  ``SamplingParams``). Greedy tokens equal plain decode's; sampled ones
  keep its distribution, drawn per position. An adaptive controller
  (``DLI_SPEC_ADAPTIVE``, on) runs plain chunks instead while drafting
  measurably loses. Under tp the leader drafts and decides, and each
  device step is a lockstep op (``spec_prefill``, ``spec_plain``,
  ``spec_verify`` with its drafts); the leader's verify outcome is
  broadcast, so every rank keeps the same tokens.
- **LoRA adapters** (``load_adapter``, ``generate(adapter=name)``, the
  JAX engine's single-stream hook): one adapter per request. Each loaded
  adapter keeps a device pack of its own (per target ``[L, 1, din, r]``
  / ``[L, 1, r, dout]`` f32, the scale folded into B) and every row
  gathers slot 0 of it (models/transformer.py ``LoRARows``), the same
  delta the batcher's mixed waves gather per row. Decode programs are
  keyed by the adapter too, and released when it is unloaded or
  reloaded. An unknown adapter raises (no request is served on base
  weights in its place); adapters with speculation raise, as the JAX
  engine's; under tp ``load_adapter`` raises (ROADMAP Queue A item
  9.11: the JAX engine lets XLA place the pack on its mesh, the port's
  lockstep ranks would need their cut of it).

- **latent attention** (deepseek): served from the latent cache, one
  [k_rot | c] row per token and layer (``latent_cache``, the JAX
  engine's rule; ``DLI_MLA_LATENT=0`` keeps the materialized per-head
  layout), ~19x fewer cache bytes at deepseek-proxy. ``kv_b_k`` /
  ``kv_b_v`` keep their stored form: the absorbed decode reads them
  whole (models/transformer.py ``_wfull``), as the JAX engine does.

The reference's CPU-only XLA workarounds (layer unrolling, weight
repacking, the dummy batch row) have no counterpart here.

Tensor parallelism (``mesh_spec=MeshSpec(tp=N)``, the reference's mesh
over tp): the engine built by the caller is rank 0, the leader. It spawns
N - 1 followers (runtime/lockstep.py), each of which builds the same
engine on its rank (``group``): random weights drawn whole on every rank
from the same seed and cut to the rank's shard (parallel/sharding.py),
the caller's tree cut the same way, or a checkpoint that every rank reads
itself, keeping its cut of each tensor as it lands (``loader``), so no
whole tree is pickled to the followers. ``generate`` and
``teacher_forced`` broadcast their op, then every rank runs the same
steps; only the leader samples, and it broadcasts each token (and each
verify step's tokens and count), so the ranks agree on every step count.
A ``stream_cb`` stays on the leader: the followers get only the flag that
puts them on the same chunked path. A speculative request holds the
lockstep lock across its ops. ``close`` stops the followers.

Pipeline and sequence parallelism (``MeshSpec(pp=N, sp=M, tp=K)``, any
composition; parallel/mesh.py lays the N·M·K ranks out as a grid): each
pp stage holds its layers and their slice of the cache, and a prefill or
a decode step runs the GPipe schedule over ``pipeline_microbatches``
(parallel/pipeline.py ``Pipeline``); each sp rank holds a contiguous
slice of the cache's positions, ``max_seq`` rounded down and the prompt
bucket up to a multiple of sp, and attention runs as a ring
(parallel/ring.py). The leader samples and broadcasts every token as
under tp. Refused as the JAX engine refuses them: ``load_adapter`` under
pp, speculation under pp or sp; the latent cache is off under either
(latent attention serves materialized).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from distributed_llm_inferencing_tpu_torch.models import lora as lora_mod
from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig
from distributed_llm_inferencing_tpu_torch.models.params import (
    init_params, param_bytes, param_count)
from distributed_llm_inferencing_tpu_torch.models.transformer import (
    LoRARows, Transformer)
from distributed_llm_inferencing_tpu_torch.ops.kvcache import (
    KVCache, init_cache)
from distributed_llm_inferencing_tpu_torch.ops.quant import (
    maybe_quantize, maybe_quantize_embed)
from distributed_llm_inferencing_tpu_torch.ops.sampling import (
    SamplingParams, row_seeds, sample)
from distributed_llm_inferencing_tpu_torch.ops.speculative import (
    AdaptiveSpecController, propose_ngram, verify_step)
from distributed_llm_inferencing_tpu_torch.parallel.mesh import (
    MeshSpec, TPGroup, grid_coords, validate_spec)
from distributed_llm_inferencing_tpu_torch.parallel.pipeline import Pipeline
from distributed_llm_inferencing_tpu_torch.parallel.ring import SeqShard
from distributed_llm_inferencing_tpu_torch.parallel.sharding import (
    chunk_markers, local_heads, shard_params, shard_tensor, stage_keep,
    stage_range)
from distributed_llm_inferencing_tpu_torch.runtime import graphs, lockstep
from distributed_llm_inferencing_tpu_torch.utils.device import resolve_device
from distributed_llm_inferencing_tpu_torch.utils.metrics import Metrics

PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def _bucket(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket")


@dataclasses.dataclass
class GenerateResult:
    tokens: List[List[int]]          # new tokens per sequence (eos-trimmed)
    prefill_ms: float
    decode_ms: float
    steps: int                       # weight passes: prefill + decode steps

    @property
    def decode_tokens_per_s(self) -> float:
        total = sum(len(t) for t in self.tokens)
        return total / (self.decode_ms / 1e3) if self.decode_ms > 0 else 0.0

    def cost(self) -> dict:
        """Engine-mode cost record, schema of the reference's."""
        return {
            "queue_ms": 0.0,
            "prefill_ms": round(self.prefill_ms, 3),
            "decode_ms": round(self.decode_ms, 3),
            "prefill_cached_tokens": 0,
            "prefill_uncached_tokens": 0,
            "decode_tokens": sum(len(t) for t in self.tokens),
            "weight_passes": self.steps,
            "engine_mode": True,
        }


class _Clock:
    """Marks on the device's clock (CUDA events) or the host's (CPU)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self, i: int, j: int) -> float:
        a, b = self.marks[i], self.marks[j]
        if self.cuda:
            b.synchronize()
            return a.elapsed_time(b)
        return (b - a) * 1e3


@dataclasses.dataclass
class _Rows:
    """The engine's decode state for one batch size B, kept across
    requests: the dense cache, the token fed next ``cur`` [B], each row's
    stream seed ``seeds`` [B], the step counter ``step`` [1] (the index of
    the token being sampled; the prefill's is 0) and the request's tokens
    so far ``hist`` [max_seq, B]; the rows' adapter slots ``lora_ids``
    [B] (all 0: an adapter request's rows gather its pack's one slot);
    and the decode programs over them, by (``SamplingParams``, captured,
    adapter), oldest first; and the verify step's drafts in and tokens
    out."""
    cache: KVCache
    cur: torch.Tensor
    seeds: torch.Tensor
    step: torch.Tensor
    hist: torch.Tensor
    lora_ids: torch.Tensor
    programs: "collections.OrderedDict" = dataclasses.field(
        default_factory=collections.OrderedDict)
    # a verify step's drafts [B, G] in, tokens [B, G+1] and emitted
    # counts [B] out (views of these at each width; made at first use)
    spec_in: Optional[torch.Tensor] = None
    spec_out: Optional[torch.Tensor] = None
    spec_n: Optional[torch.Tensor] = None

    def release(self):
        for prog in self.programs.values():
            prog.release()
        self.programs.clear()

    def release_adapter(self, name: str):
        """Release the decode programs of adapter ``name``."""
        for key in [k for k in self.programs if k[-1] == name]:
            self.programs.pop(key).release()


def latent_cache(cfg: ModelConfig, spec: Optional[MeshSpec] = None) -> bool:
    """Whether the engine serves ``cfg`` from the latent cache (the JAX
    engine's rule): latent attention with no int8 KV cache, no window, no
    score softcap and no sp or pp axis, unless ``DLI_MLA_LATENT=0`` asks
    for the materialized layout (tp refuses latent attention,
    ``tp_gaps``)."""
    spec = spec or MeshSpec()
    return (cfg.mla and cfg.kv_quant is None and cfg.sliding_window is None
            and cfg.attn_windows is None and cfg.attn_softcap is None
            and spec.sp == 1 and spec.pp == 1
            and os.environ.get("DLI_MLA_LATENT") != "0")


def rank_params(cfg: ModelConfig, spec: MeshSpec, rank: int, dev,
                params=None, seed: int = 0, loader: Optional[Callable] = None):
    """Grid rank ``rank``'s weights on ``dev`` (all of them on one
    device): its pp stage's leaves (parallel/sharding.py ``stage_keep``),
    each cut to its tp rank's shard; from ``loader(device, shard)`` (a
    checkpoint, models/checkpoint.py ``CheckpointSource.load``: every
    rank reads its stage's tensors and keeps its cut), from the caller's
    tree, or drawn from ``seed`` (every leaf drawn in pp=1's order, the
    other stages' dropped as drawn)."""
    stage, _, t_rank = grid_coords(spec, rank)
    keep = stage_keep(cfg, spec, stage)
    layers = stage_range(cfg, spec, stage)

    def cut(n, t):
        if keep is not None and not keep(n):
            return None
        return shard_tensor(n, t, cfg, spec, t_rank) if spec.tp > 1 else t
    cut.keep = keep
    if loader is not None:
        params = loader(dev, cut)
        params.update(chunk_markers(cfg, spec, dev, layers))
    elif params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(cfg, gen, dev, shard=cut)
        params.update(chunk_markers(cfg, spec, dev, layers))
    else:
        # weight-only quantization of a float tree (ops/quant.py), on
        # the device, one weight at a time, before any cut (a scale
        # spans the whole din); a quantized tree passes
        params = shard_params(maybe_quantize_embed(maybe_quantize(
            {k: t.to(dev) for k, t in params.items()
             if keep is None or keep(k)}, cfg), cfg), cfg,
            MeshSpec(tp=spec.tp), t_rank)
        if keep is not None:   # the other stages' chunk markers
            params = {k: t for k, t in params.items() if keep(k)}
    return params


class InferenceEngine:
    """Owns one model's weights on one device (or one tp rank's shard of
    them) and serves ``generate``."""

    # decode chunks of the eos path: the host syncs once per chunk to
    # look for eos, never per token
    DECODE_CHUNKS = (64, 32, 16, 8, 4, 2, 1)
    STREAM_CHUNK_MAX = 32
    # decode programs kept per batch size (FIFO), the JAX engine's cap on
    # _decode_fns: ~8 sampling configs' worth of its chunk schedule
    PROGRAMS_MAX = 8 * len(DECODE_CHUNKS)
    # batch sizes whose _Rows stay allocated between requests (LRU): each
    # holds 2 x L x B x max_seq x Hkv x hd cache elements, 512 MiB per
    # row at llama-3-8b with max_seq 4096 in bf16
    ROWS_KEPT = 2

    def __init__(self, cfg: ModelConfig, params=None, *,
                 mesh_spec: Optional[MeshSpec] = None,
                 max_seq: Optional[int] = None, seed: int = 0, device=None,
                 metrics: Optional[Metrics] = None,
                 group: Optional[TPGroup] = None,
                 loader: Optional[Callable] = None,
                 pipeline_microbatches: Optional[int] = None):
        self.metrics = metrics or Metrics()
        self.mesh_spec = spec = mesh_spec or MeshSpec()
        validate_spec(spec, cfg)
        self.cfg = cfg = cfg.replace(
            mla_latent_cache=latent_cache(cfg, spec))
        self.max_seq = min(max_seq or cfg.max_position_embeddings,
                           cfg.max_position_embeddings)
        # sp cuts the cache's positions: rounded down, never past the
        # model's window (the JAX engine's rule)
        self.max_seq -= self.max_seq % spec.sp
        self._n_micro = pipeline_microbatches
        self.group = group
        self._leader = None
        # one lockstep op, or one speculative request's ops, at a time
        self._lock = threading.RLock()
        self.device = base = resolve_device(device)
        if group is not None:
            self.device = group.device
        if spec.world > 1 and group is None:   # the leader: spawn the rest
            self._leader = lockstep.leader(spec.world, base)
            self.device = self._leader.group.device
            self.group = self._leader.group
            cpu = (None if params is None
                   else {k: t.cpu() for k, t in params.items()})
            try:
                self._leader.run("load", dict(
                    cfg=cfg, params=cpu, mesh_spec=spec, max_seq=max_seq,
                    seed=seed, device=str(base), loader=loader,
                    pipeline_microbatches=pipeline_microbatches),
                    lambda: self._load(params, seed, loader))
            except BaseException:
                self._leader.stop()
                raise
        else:
            self._load(params, seed, loader)
        self._buckets_seen = set()
        self._rows: "collections.OrderedDict[int, _Rows]" = \
            collections.OrderedDict()
        self.programs = graphs.DecodePrograms(self.device, self.metrics)
        # LoRA adapters: name -> LoRAAdapter, and its device pack
        self._adapters: dict = {}
        self._adapter_packs: dict = {}

    def _load(self, params, seed, loader=None):
        """Lay the group out as the mesh's grid, then build this rank's
        weights (``rank_params``), its stage's model over its tp and sp
        groups, and the pipeline over it under pp (``runner``: what a
        prefill or decode step calls)."""
        spec, grp = self.mesh_spec, self.group
        if grp is not None:
            grp.configure(spec)
        rank = grp.rank if grp else 0
        self.params = rank_params(self.cfg, spec, rank, self.device, params,
                                  seed, loader)
        stage = grid_coords(spec, rank)[0]
        seq = None
        if spec.sp > 1:
            seq = SeqShard(grp.sp_ring, grp.sp, grp.coords[1], spec.sp,
                           self.max_seq // spec.sp)
        self.model = Transformer(
            self.cfg, self.params, None if grp is None else grp.tp,
            layers=stage_range(self.cfg, spec, stage), seq=seq)
        self.runner = (Pipeline(self.model, grp, self._n_micro)
                       if spec.pp > 1 else self.model)

    def _op(self, name: str, _local: Optional[dict] = None, **kw):
        """Run ``_<name>`` here, and on every follower under tp with
        ``kw``; ``_local`` holds the leader's own arguments (callbacks),
        which never go over the wire."""
        fn = getattr(self, "_" + name)
        mine = dict(kw, **(_local or {}))
        if self._leader is None:
            return fn(**mine)
        with self._lock:
            return self._leader.run(name, kw, lambda: fn(**mine))

    def _sample(self, logits, key, sp):
        """The next tokens: sampled here, or under tp sampled on the
        leader and broadcast, so every rank feeds the same tokens."""
        if self.group is None:
            return sample(logits, key, sp)
        if self.group.rank == 0:
            cur = sample(logits, key, sp)
        else:
            cur = torch.empty(logits.shape[0], dtype=torch.int64,
                              device=self.device)
        return self.group.broadcast(cur)

    def _check_request(self, prompts, max_new_tokens):
        lens = [len(p) for p in prompts]
        if not lens or min(lens) < 1:
            raise ValueError("empty prompt")
        if max(lens) + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({max(lens)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds engine max_seq {self.max_seq} "
                f"(context window {self.cfg.max_position_embeddings})")

    def _prefill(self, prompts, cache, gather, lora=None):
        """Right-pad ``prompts`` into their bucket (under sp rounded up to
        a multiple of sp) and prefill ``cache``; ``gather``: keep only
        each prompt's last position; ``lora``: the rows' adapter."""
        lens = [len(p) for p in prompts]
        s0 = min(_bucket(max(lens)), self.max_seq)
        sp = self.mesh_spec.sp
        s0 = min(s0 + (-s0 % sp), self.max_seq)
        host = torch.zeros((len(prompts), s0), dtype=torch.int64)
        for i, p in enumerate(prompts):
            host[i, :len(p)] = torch.as_tensor(p, dtype=torch.int64)
        lengths = torch.tensor(lens, dtype=torch.int32, device=self.device)
        self._buckets_seen.add(s0)
        return self.runner.prefill(
            host.to(self.device), lengths, cache,
            gather=(lengths - 1).long() if gather else None, lora=lora)

    def _cache(self, batch: int):
        """A dense cache of this rank's share: its tp kv heads, its pp
        stage's layers, its sp slice of the positions."""
        spec = self.mesh_spec
        return init_cache(self.cfg, batch, self.max_seq // spec.sp,
                          device=self.device,
                          num_kv_heads=local_heads(self.cfg, spec)[1],
                          num_layers=len(self.model.layers))

    def _state(self, batch: int) -> _Rows:
        """The kept ``_Rows`` of ``batch``, made on first use; making one
        past ``ROWS_KEPT`` frees the least recently used and releases its
        programs."""
        st = self._rows.get(batch)
        if st is not None:
            self._rows.move_to_end(batch)
            return st
        if len(self._rows) >= self.ROWS_KEPT:
            self._rows.popitem(last=False)[1].release()
        z = functools.partial(torch.zeros, dtype=torch.int64,
                              device=self.device)
        st = self._rows[batch] = _Rows(
            cache=self._cache(batch), cur=z(batch), seeds=z(batch),
            step=z(1), hist=z((self.max_seq, batch)), lora_ids=z(batch))
        return st

    def _advance(self, st: _Rows, logits, sp):
        """Sample each row's token of step ``st.step`` from logits [B, V],
        feed it next, keep it in ``st.hist`` and count the step: device
        work only, no host sync."""
        nxt = self._sample(logits, (st.seeds, st.step), sp)
        st.cur.copy_(nxt)
        st.hist.index_copy_(0, st.step, nxt[None])
        st.step.add_(1)

    def _decode_step(self, st: _Rows, sp, lora=None):
        """One decode step of every row over ``st``, in place: the
        program a decode program runs (captured or eager)."""
        logits, _ = self.runner.decode_step(st.cur[:, None], st.cache, lora)
        self._advance(st, logits[:, 0], sp)

    def _verify(self, st: _Rows, sp, gamma: int):
        """One verify step of every row over ``st``, in place: the drafts
        in ``st.spec_in[:, :gamma]``, the tokens and counts out in
        ``st.spec_out``/``st.spec_n``; the last emitted token is fed
        next and the step counter moves by the emitted count (the draws
        are keyed per position)."""
        toks, n = verify_step(self.model, st.cache, st.cur,
                              st.spec_in[:, :gamma], (st.seeds, st.step), sp)
        if self.group is not None:   # the leader's outcome on every rank
            both = self.group.broadcast(torch.cat([n[:, None], toks], 1))
            n, toks = both[:, 0], both[:, 1:]
        st.spec_out[:, :gamma + 1].copy_(toks)
        st.spec_n.copy_(n)
        st.cur.copy_(torch.gather(toks, 1, (n - 1)[:, None])[:, 0])
        st.step.add_(n[:1])

    def _program(self, st: _Rows, sp, gamma: int = 0,
                 adapter: Optional[str] = None) -> graphs.DecodeProgram:
        """The decode program of (batch size, ``sp``, ``adapter``), or
        with ``gamma`` the verify step of (batch size, gamma, ``sp``),
        kept in ``st`` up to ``PROGRAMS_MAX`` (FIFO): captured on a card
        unless ``DLI_CUDA_GRAPHS=0``; eager on the CPU and under tp (the
        gloo data group cannot be captured). An adapter's program reads
        its pack, whose addresses hold until it is unloaded or reloaded,
        which releases the program."""
        capture = graphs.enabled(self.device) and self.group is None
        key = ((sp, capture, adapter) if not gamma
               else ("spec", gamma, sp, capture, None))
        prog = st.programs.get(key)
        if prog is None:
            if len(st.programs) >= self.PROGRAMS_MAX:
                st.programs.popitem(last=False)[1].release()
            lora = (None if adapter is None else
                    LoRARows(self._adapter_packs[adapter], st.lora_ids))
            fn = (functools.partial(self._decode_step, st, sp, lora)
                  if not gamma
                  else functools.partial(self._verify, st, sp, gamma))
            prog = st.programs[key] = self.programs.make(fn, capture)
        return prog

    # ---- LoRA adapters (single-stream delta hook) ---------------------

    def load_adapter(self, adapter=None, *, name=None, source=None):
        """Make a LoRA adapter available to ``generate(adapter=...)``: a
        ``models.lora.LoRAAdapter``, or ``name`` + ``source`` (a
        checkpoint directory or a ``synth:`` URI). ValueError on any
        problem. Reloading a name replaces its pack and releases its
        decode programs."""
        if self.mesh_spec.pp > 1:
            raise ValueError(
                "LoRA serving does not support pp > 1 (as the JAX engine: "
                "the stages hold no delta pack)")
        if self.group is not None:
            raise ValueError(
                "LoRA adapters under tp or sp are not ported yet (ROADMAP "
                "Queue A item 9.11); load the model without a mesh")
        if adapter is None:
            adapter = lora_mod.resolve(self.cfg, name, source)
        else:
            lora_mod.check_adapter(self.cfg, adapter)
        # per target {"a": [L, 1, din, r], "b": [L, 1, r, dout]}, the
        # alpha / rank scale folded into B (the JAX engine's tree)
        targets = adapter.layers[0].keys() if adapter.layers else ()
        pack = {}
        for t in targets:
            rows = [lora_mod.slot_arrays(self.cfg, adapter, t, li,
                                         adapter.rank)
                    for li in range(self.cfg.num_layers)]
            pack[t] = {k: torch.from_numpy(np.stack([r[j][None]
                                                     for r in rows]))
                       .to(self.device) for j, k in enumerate(("a", "b"))}
        self._drop_adapter_programs(adapter.name)
        self._adapters[adapter.name] = adapter
        self._adapter_packs[adapter.name] = pack
        return adapter

    def unload_adapter(self, name: str) -> bool:
        self._drop_adapter_programs(name)
        self._adapter_packs.pop(name, None)
        return self._adapters.pop(name, None) is not None

    def _drop_adapter_programs(self, name: str):
        for st in self._rows.values():
            st.release_adapter(name)

    def adapter_stats(self) -> dict:
        """The resident adapters, for the worker's /health (the master's
        adapter affinity reads it)."""
        return {"resident": sorted(self._adapters),
                "bytes": sum(a.nbytes for a in self._adapters.values())}

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int = 100,
        sampling: Optional[SamplingParams] = None,
        seed: int = 0,
        eos_token_id: Optional[int] = None,
        stream_cb: Optional[Callable[[int, List[Optional[int]]],
                                     None]] = None,
        speculative: Optional[str] = None,
        spec_gamma: int = 4,
        adapter: Optional[str] = None,
    ) -> GenerateResult:
        """Generate continuations for a batch of token-id prompts; a
        sequence stops after ``eos_token_id`` (trimmed from its tokens).
        ``stream_cb(step, tokens_this_step)`` fires after prefill and
        after every decode step (finished rows as None).
        ``speculative="ngram"``: prompt-lookup speculative decoding of one
        sequence, ``spec_gamma`` drafts per verify step. ``adapter``: a
        loaded LoRA adapter every row runs through (ValueError for one
        not loaded)."""
        if speculative is not None and adapter is not None:
            raise ValueError(
                "LoRA adapters do not combine with speculative decoding "
                "(the verify program has no delta hook)")
        if adapter is not None and adapter not in self._adapters:
            raise ValueError(
                f"unknown adapter {adapter!r} (load_adapter first)")
        if speculative is not None:
            return self._generate_speculative(
                prompts, max_new_tokens, sampling or SamplingParams(),
                int(seed), eos_token_id, stream_cb, speculative,
                spec_gamma)
        prompts = [list(map(int, p)) for p in prompts]
        if max_new_tokens < 1:
            if not prompts or min(map(len, prompts)) < 1:
                raise ValueError("empty prompt")
            return GenerateResult([[] for _ in prompts], 0.0, 0.0, 0)
        self._check_request(prompts, max_new_tokens)
        return self._op("generate", prompts=prompts,
                        max_new_tokens=int(max_new_tokens),
                        sampling=sampling or SamplingParams(),
                        seed=int(seed), eos_token_id=eos_token_id,
                        stream=stream_cb is not None, adapter=adapter,
                        _local={"stream_cb": stream_cb})

    @torch.inference_mode()
    def _generate(self, prompts, max_new_tokens, sampling, seed,
                  eos_token_id, stream=False, adapter=None,
                  stream_cb=None) -> GenerateResult:
        dev, sp = self.device, sampling
        n = len(prompts)
        st = self._state(n)
        st.seeds.copy_(row_seeds(seed, n, dev))
        st.step.zero_()
        step = self._program(st, sp, adapter=adapter)
        lora = (None if adapter is None else
                LoRARows(self._adapter_packs[adapter], st.lora_ids))

        clock = _Clock(dev)
        clock.mark()
        last, filled = self._prefill(prompts, st.cache, gather=True,
                                     lora=lora)
        st.cache.lengths.copy_(filled.lengths)
        self._advance(st, last[:, 0], sp)
        clock.mark()

        steps = 1
        remaining = max_new_tokens - 1
        if eos_token_id is None and not stream:
            for _ in range(remaining):
                step()
            steps += remaining
            clock.mark()
            out = st.hist[:steps].T.tolist()   # the one sync
        else:
            # eos stop and/or streaming: the host sees each chunk
            out = [[t] for t in st.hist[0].tolist()]
            done = [o[0] == eos_token_id for o in out]
            if stream_cb:
                stream_cb(0, [o[0] for o in out])
            while remaining > 0 and not all(done):
                T = next(c for c in self.DECODE_CHUNKS
                         if c <= min(remaining, self.STREAM_CHUNK_MAX))
                for _ in range(T):
                    step()
                rows = st.hist[steps:steps + T].tolist()   # one sync/chunk
                for t, row in enumerate(rows):
                    if stream_cb:   # stream what lands in `out` this step
                        emit = [None if done[i] else row[i]
                                for i in range(n)]
                        if any(e is not None for e in emit):
                            stream_cb(steps + t, emit)
                    for i in range(n):
                        if not done[i]:
                            out[i].append(row[i])
                            done[i] = row[i] == eos_token_id
                steps += T
                remaining -= T
            clock.mark()
            out = [t[:-1] if t[-1] == eos_token_id else t for t in out]
        prefill_ms, decode_ms = clock.ms(0, 1), clock.ms(1, 2)
        self.metrics.observe("engine_prefill", prefill_ms / 1e3)
        self.metrics.observe("engine_decode", decode_ms / 1e3)
        self.metrics.inc("engine_decode_steps", steps)
        return GenerateResult(tokens=out, prefill_ms=prefill_ms,
                              decode_ms=decode_ms, steps=steps)

    def _generate_speculative(self, prompts, max_new_tokens, sp, seed,
                              eos_token_id, stream_cb, mode, gamma):
        """The prompt-lookup loop (the JAX engine's
        ``_generate_speculative``): the verify program per step, 1 to
        gamma + 1 tokens per host sync, or plain chunks while the
        adaptive controller says drafting loses. The leader drafts and
        decides; each device step is an op (``_spec_*``) every tp rank
        runs."""
        if mode != "ngram":
            raise ValueError(f"unknown speculative mode {mode!r}")
        if len(prompts) != 1:
            raise ValueError("speculative decoding serves one sequence")
        if self.mesh_spec.sp > 1 or self.mesh_spec.pp > 1:
            raise ValueError("speculative decoding supports tp meshes (not "
                             "sp or pp, as the JAX engine)")
        gamma = max(1, int(gamma))
        prompt = [int(t) for t in prompts[0]]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            return GenerateResult([[]], 0.0, 0.0, 0)
        if len(prompt) + max_new_tokens + gamma + 1 > self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens})"
                f" + gamma ({gamma}) exceeds engine max_seq {self.max_seq}")
        with self._lock:   # no other request's op between this one's
            return self._speculative_loop(prompt, max_new_tokens, sp, seed,
                                          eos_token_id, stream_cb, gamma)

    def _speculative_loop(self, prompt, max_new_tokens, sp, seed,
                          eos_token_id, stream_cb, gamma):
        clock = _Clock(self.device)
        clock.mark()
        cur = self._op("spec_prefill", prompt=prompt, sp=sp, seed=seed)
        clock.mark()
        st = self._rows[1]
        hit_eos = eos_token_id is not None and cur == eos_token_id
        out: List[int] = [] if hit_eos else [cur]
        if stream_cb and not hit_eos:
            stream_cb(0, [cur])
        history = prompt + out
        steps, pos = 1, 1          # weight passes; tokens sampled so far
        # fresh per request (its tokens are a function of its own
        # inputs), with a short probe cadence, as the JAX engine's
        ctl = (AdaptiveSpecController(gamma, probe_every=8)
               if os.environ.get("DLI_SPEC_ADAPTIVE", "1")
               not in ("0", "false") else None)
        while len(out) < max_new_tokens and not hit_eos:
            g_now = ctl.choose() if ctl is not None else gamma
            p0 = time.perf_counter()
            if g_now == 0:
                rem = max_new_tokens - len(out)
                T = next(c for c in self.DECODE_CHUNKS
                         if c <= min(rem, self.STREAM_CHUNK_MAX))
                compiled = self._op("spec_plain", sp=sp, n=T)
                emitted = st.hist[pos:pos + T, 0].tolist()
                steps += T
            else:
                drafts = propose_ngram(history, g_now) \
                    or [history[-1]] * g_now
                compiled = self._op("spec_verify", sp=sp, drafts=drafts)
                both = torch.cat([st.spec_n, st.spec_out[0]]).tolist()
                emitted = both[1:1 + both[0]]
                steps += 1
            pos += len(emitted)
            kept = []
            for t in emitted:
                if eos_token_id is not None and t == eos_token_id:
                    hit_eos = True
                    break
                kept.append(t)
                if len(out) + len(kept) >= max_new_tokens:
                    break
            if ctl is not None:
                dt = time.perf_counter() - p0
                if g_now == 0:
                    ctl.record("plain", emitted=len(emitted), elapsed_s=dt,
                               compiled=compiled)
                else:
                    ctl.record("spec", emitted=len(emitted), elapsed_s=dt,
                               drafted=g_now, accepted=len(emitted) - 1,
                               compiled=compiled)
            out.extend(kept)
            history.extend(kept)
            if stream_cb:
                for j, t in enumerate(kept):
                    stream_cb(len(out) - len(kept) + j, [t])
        clock.mark()
        prefill_ms, decode_ms = clock.ms(0, 1), clock.ms(1, 2)
        self.metrics.observe("engine_prefill", prefill_ms / 1e3)
        self.metrics.observe("engine_decode", decode_ms / 1e3)
        self.metrics.inc("engine_decode_steps", steps)
        return GenerateResult(tokens=[out], prefill_ms=prefill_ms,
                              decode_ms=decode_ms, steps=steps)

    @torch.inference_mode()
    def _spec_prefill(self, prompt, sp, seed):
        """A speculative request's prefill and first token into the
        batch-1 rows. Returns the token."""
        dev = self.device
        st = self._state(1)
        if st.spec_in is None:
            z = functools.partial(torch.zeros, dtype=torch.int64, device=dev)
            st.spec_in, st.spec_out, st.spec_n = z((1, 16)), z((1, 17)), z(1)
        st.seeds.copy_(row_seeds(seed, 1, dev))
        st.step.zero_()
        last, filled = self._prefill([prompt], st.cache, gather=True)
        st.cache.lengths.copy_(filled.lengths)
        self._advance(st, last[:, 0], sp)
        return int(st.hist[0, 0])

    @torch.inference_mode()
    def _spec_plain(self, sp, n):
        """``n`` plain decode steps of the batch-1 rows. Returns whether
        the program captured its graph on this call (its time then is
        not decode time, for the controller)."""
        prog = self._program(self._rows[1], sp)
        compiled = prog.graphs is not None and not prog.captured
        for _ in range(n):
            prog()
        return compiled

    @torch.inference_mode()
    def _spec_verify(self, sp, drafts):
        """One verify step of the batch-1 rows over ``drafts``. Returns
        whether it captured, as ``_spec_plain``."""
        st = self._rows[1]
        st.spec_in[0, :len(drafts)].copy_(torch.tensor(drafts))
        prog = self._program(st, sp, len(drafts))
        compiled = prog.graphs is not None and not prog.captured
        prog()
        return compiled

    def teacher_forced(self, prompts: Sequence[Sequence[int]],
                       forced: Sequence[Sequence[int]],
                       last_only: bool = False):
        """Logits of a prefill of ``prompts`` followed by one decode step
        per row of ``forced`` ([steps][B] tokens fed, not sampled), f32 on
        the host: (prefill [B, S, V], or [B, V] with ``last_only``, the
        right-padded block's rows; decode [steps, B, V])."""
        prompts = [list(map(int, p)) for p in prompts]
        forced = [list(map(int, row)) for row in forced]
        self._check_request(prompts, len(forced))
        return self._op("teacher_forced", prompts=prompts, forced=forced,
                        last_only=bool(last_only))

    @torch.inference_mode()
    def _teacher_forced(self, prompts, forced, last_only):
        cache = self._cache(len(prompts))
        first, cache = self._prefill(prompts, cache, gather=last_only)
        steps = []
        for row in forced:
            tok = torch.tensor(row, dtype=torch.int64, device=self.device)
            logits, cache = self.runner.decode_step(tok[:, None], cache)
            steps.append(logits[:, 0].cpu())
        first = first[:, 0] if last_only else first
        return first.cpu(), torch.stack(steps) if steps else None

    def rank_stats(self) -> List[dict]:
        """Every rank's kernel launches and data collectives, the
        leader's first (one entry without tp)."""
        out = self._op("stats")
        return out if self._leader is not None else [out]

    def _stats(self):
        return dict(lockstep.rank_stats(self.group, self.device),
                    param_bytes=param_bytes(self.params),
                    layers=[self.model.layer_range.start,
                            self.model.layer_range.stop])

    def reset_counts(self):
        """Zero the kernel launch and collective counts on every rank."""
        self._op("reset_counts")

    def _reset_counts(self):
        lockstep.reset_counts(self.group)

    def close(self):
        """Release the decode programs (their graphs and pool) and the
        kept decode state, and stop the followers (tp); raises if one had
        to be killed."""
        self.programs.release()
        self._rows.clear()
        if self._leader is not None:
            with self._lock:
                self._leader.stop()

    def stats(self) -> dict:
        out = {
            "model": self.cfg.name,
            "device": str(self.device),
            "mesh": self.mesh_spec.axis_sizes(),
            "params": param_count(self.params),
            "param_bytes": param_bytes(self.params),
            "max_seq": self.max_seq,
            "prefill_buckets_seen": sorted(self._buckets_seen),
            "adapters": sorted(self._adapters),
            **self.programs.stats(),
        }
        if self.group is not None:
            # this rank's share; every rank holds the same amount
            out["backend"] = self.group.backend
            out["ranks"] = self.group.world
        return out
