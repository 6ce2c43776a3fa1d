"""InferenceEngine: bucketed prefill, token-by-token decode, sampling.

Port of the reference's ``runtime/engine.py`` engine mode for one model on
one device:

- **prefill**: one forward over a right-padded prompt block whose length
  is rounded up to a bucket (``_bucket``); the last real logit of each
  sequence is gathered before the head.
- **decode**: one forward per token over the dense cache, updated in
  place; sampling runs on the device with a per-request generator.
- **host syncs**: tokens stay on the device. With no eos stop the host
  syncs once per request; with one, once per decode chunk
  (``DECODE_CHUNKS``, capped at ``STREAM_CHUNK_MAX``), which is when it
  must see tokens — the reference's schedule.

PyTorch runs eagerly, so the reference's compiled-program caches and its
CPU-only XLA workarounds (layer unrolling, weight repacking, the dummy
batch row) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import torch

from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig
from distributed_llm_inferencing_tpu_torch.models.params import (
    init_params, param_bytes, param_count)
from distributed_llm_inferencing_tpu_torch.models.transformer import (
    Transformer)
from distributed_llm_inferencing_tpu_torch.ops.kvcache import init_cache
from distributed_llm_inferencing_tpu_torch.ops.quant import (
    maybe_quantize, maybe_quantize_embed)
from distributed_llm_inferencing_tpu_torch.ops.sampling import (
    SamplingParams, sample)
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


class InferenceEngine:
    """Owns one model's weights on one device and serves ``generate``."""

    # decode chunks of the eos path: the host syncs once per chunk to
    # look for eos, never per token
    DECODE_CHUNKS = (64, 32, 16, 8, 4, 2, 1)
    STREAM_CHUNK_MAX = 32

    def __init__(self, cfg: ModelConfig, params=None, *,
                 max_seq: Optional[int] = None, seed: int = 0, device=None,
                 metrics: Optional[Metrics] = None):
        self.metrics = metrics or Metrics()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_seq = min(max_seq or cfg.max_position_embeddings,
                           cfg.max_position_embeddings)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, self.device)
        else:
            # weight-only quantization of a float tree (ops/quant.py), on
            # the device, one weight at a time; a quantized tree passes
            params = maybe_quantize_embed(maybe_quantize(
                {k: t.to(self.device) for k, t in params.items()}, cfg), cfg)
        self.params = params
        self.model = Transformer(cfg, params)
        self._buckets_seen = set()

    @torch.inference_mode()
    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int = 100,
        sampling: Optional[SamplingParams] = None,
        seed: int = 0,
        eos_token_id: Optional[int] = None,
    ) -> GenerateResult:
        """Generate continuations for a batch of token-id prompts; a
        sequence stops after ``eos_token_id`` (trimmed from its tokens)."""
        cfg, dev = self.cfg, self.device
        sp = sampling or SamplingParams()
        n = len(prompts)
        lens = [len(p) for p in prompts]
        if not lens or min(lens) < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            return GenerateResult([[] for _ in range(n)], 0.0, 0.0, 0)
        max_len = max(lens)
        if max_len + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({max_len}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds engine max_seq {self.max_seq} "
                f"(context window {cfg.max_position_embeddings})")

        s0 = min(_bucket(max_len), self.max_seq)
        host = torch.zeros((n, s0), dtype=torch.int64)
        for i, p in enumerate(prompts):
            host[i, :len(p)] = torch.as_tensor(p, dtype=torch.int64)
        tokens = host.to(dev)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        cache = init_cache(cfg, n, self.max_seq, device=dev)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        self._buckets_seen.add(s0)

        clock = _Clock(dev)
        clock.mark()
        last, cache = self.model.prefill(
            tokens, lengths, cache, gather=(lengths - 1).long())
        cur = sample(last[:, 0], gen, sp)
        clock.mark()

        steps = 1
        remaining = max_new_tokens - 1
        if eos_token_id is None:
            toks = [cur]
            for _ in range(remaining):
                logits, cache = self.model.decode_step(cur[:, None], cache)
                cur = sample(logits[:, 0], gen, sp)
                toks.append(cur)
            steps += remaining
            clock.mark()
            out = torch.stack(toks, dim=1).tolist()   # the one sync
        else:
            out = [[t] for t in cur.tolist()]
            done = [o[0] == eos_token_id for o in out]
            while remaining > 0 and not all(done):
                T = next(c for c in self.DECODE_CHUNKS
                         if c <= min(remaining, self.STREAM_CHUNK_MAX))
                chunk = []
                for _ in range(T):
                    logits, cache = self.model.decode_step(cur[:, None],
                                                           cache)
                    cur = sample(logits[:, 0], gen, sp)
                    chunk.append(cur)
                rows = torch.stack(chunk, dim=0).tolist()  # one sync/chunk
                for row in rows:
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

    def stats(self) -> dict:
        return {
            "model": self.cfg.name,
            "device": str(self.device),
            "params": param_count(self.params),
            "param_bytes": param_bytes(self.params),
            "max_seq": self.max_seq,
            "prefill_buckets_seen": sorted(self._buckets_seen),
        }
