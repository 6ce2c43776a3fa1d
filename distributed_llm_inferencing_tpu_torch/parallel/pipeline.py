"""Pipeline parallelism in the engine: a GPipe schedule over pp stages.

Port of the JAX package's ``parallel/pipeline.py``. Stage p of pp holds
layers [p·L/pp, (p+1)·L/pp) whole and its layers' slice of the dense
cache (runtime/engine.py ``rank_params``; models/transformer.py
``Transformer(layers=...)``). A prefill and each decode step run the
GPipe schedule over M microbatches of the batch (``pick_n_micro``, the
JAX rule): at tick t stage p works on microbatch t − p, stage 0 embeds,
each stage's output hops to stage p + 1 (parallel/mesh.py ``Ring``), and
the last stage's logits hop to stage 0, whose leader samples and
broadcasts the tokens as under tp (runtime/engine.py ``_sample``). The
JAX package runs every stage through every tick with masks (one SPMD
program); here a stage computes only its valid ticks, and both ends of a
hop derive from (t, p, M) alone whether it happens, so every rank posts
the same hops in the same order.

A stage's layers run the same routes as at pp=1 (the attention kernels,
``q4_matmul``, and under pp×tp ``q4_matmul_row``); under pp×sp a
stage's attention is the ring over its sp group (parallel/ring.py).
Each microbatch is its own call, so what depends on a call's rows
follows the microbatch, as in the JAX pipeline: GEMM shapes (f32 bits
may differ from pp=1's) and the experts' capacity dispatch, whose slots
per expert count the microbatch's positions (``pipeline_microbatches=1``
keeps pp=1's). Decode is eager under pp: the gloo hops cannot be
captured.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from distributed_llm_inferencing_tpu_torch.ops.kvcache import KVCache
from distributed_llm_inferencing_tpu_torch.parallel.mesh import (
    pack, packed_size, unpack)


def pick_n_micro(batch: int, pp: int, requested: Optional[int] = None
                 ) -> int:
    """Largest divisor of ``batch`` up to 2·pp (the JAX package's rule:
    enough microbatches to amortize the pp − 1 tick bubble, each still
    fat). A requested count is a target: one that does not divide the
    batch clamps to their gcd."""
    if requested:
        return max(1, math.gcd(requested, batch))
    return next(m for m in range(min(batch, 2 * pp), 0, -1)
                if batch % m == 0)


def cache_rows(cache: KVCache, rows: slice) -> KVCache:
    """Views of ``cache``'s rows ``rows`` (writes land in ``cache``)."""
    return KVCache(*(None if t is None else (t[:, rows] if t.dim() > 1
                                             else t[rows])
                     for t in (cache.k, cache.v, cache.lengths,
                               cache.k_scale, cache.v_scale)))


class Pipeline:
    """One rank's stage of a pipelined model, with the ``prefill`` /
    ``decode_step`` of ``Transformer`` (the engine calls either):
    ``model`` is the stage's ``Transformer``, ``group`` the configured
    ``TPGroup`` (its ``pp`` ring and ``coords``), ``n_micro`` the
    requested microbatches (``pipeline_microbatches``). The logits come
    back on stage 0 (and the last stage); other stages get an empty
    [B, s, 0] tensor of the same rows."""

    def __init__(self, model, group, n_micro: Optional[int] = None):
        self.model, self.group = model, group
        self.pp = group.spec.pp
        self.stage = group.coords[0]
        self.n_micro = n_micro

    def prefill(self, tokens, lengths, cache: KVCache, gather=None,
                lora=None):
        """``lora`` is always None: pp refuses adapters at their load."""
        B, s = tokens.shape
        pos = torch.arange(s, device=tokens.device).expand(B, s)
        return self.forward(
            tokens, cache, torch.zeros(B, dtype=torch.int32,
                                       device=tokens.device),
            pos, lengths, is_prefill=True, gather=gather)

    def decode_step(self, tokens, cache: KVCache, lora=None):
        new_lengths = cache.lengths + 1
        logits, _ = self.forward(tokens, cache, cache.lengths,
                                 cache.lengths[:, None], new_lengths)
        cache.lengths.copy_(new_lengths)
        return logits, cache

    def forward(self, tokens, cache: KVCache, write_starts, q_positions,
                new_lengths, is_prefill: bool = False, gather=None):
        """``Transformer.forward`` over the stages: returns (logits,
        cache) on stage 0, (empty, cache) on a middle stage."""
        model, pp, p = self.model, self.pp, self.stage
        last = p == pp - 1
        seq = model.seq
        B = tokens.shape[0]
        s_out = 1 if gather is not None else tokens.shape[1]
        if seq is not None and is_prefill:
            tokens, q_positions = seq.chunk(tokens), seq.chunk(q_positions)
        s = tokens.shape[1]
        n_micro = pick_n_micro(B, pp, self.n_micro)
        mb = B // n_micro
        x_like = [((mb, s, model.cfg.hidden_size), model.dtype)]
        out = None
        if last:
            out = torch.empty((B, s_out, model.cfg.vocab_size),
                              dtype=torch.float32, device=tokens.device)
        got = None
        for t in range(n_micro + pp - 1):
            m = t - p
            x = None
            if 0 <= m < n_micro:
                rows = slice(m * mb, (m + 1) * mb)
                x = (model.embed(tokens[rows], q_positions[rows]) if p == 0
                     else unpack(got, x_like)[0])
                x = model.run_layers(
                    x, cache_rows(cache, rows), write_starts[rows],
                    q_positions[rows], new_lengths[rows], is_prefill)
                if last:
                    out[rows] = model.head(
                        x, None if gather is None else gather[rows],
                        is_prefill)
            # the hop from stage p to p + 1 carries the output of p's tick
            send = pack([x]) if x is not None and not last else None
            recv = (packed_size(x_like)
                    if p > 0 and 0 <= t - (p - 1) < n_micro else 0)
            got = self.group.pp.exchange(send, recv)
        o_like = [((B, s_out, model.cfg.vocab_size), torch.float32)]
        if last:
            self.group.pp.exchange(pack([out]), 0)
        elif p == 0:
            out = unpack(self.group.pp.exchange(None, packed_size(o_like)),
                         o_like)[0]
        else:
            out = torch.empty((B, s_out, 0), dtype=torch.float32,
                              device=tokens.device)
        return out, dataclasses.replace(cache, lengths=new_lengths)
