"""Which part of each weight a tp rank holds (megatron-style).

The JAX package's ``parallel/sharding.py`` assigns a ``PartitionSpec`` per
leaf (``param_specs``) and lets GSPMD place the shards; here each rank
cuts its own shard out of the port's flat dict (models/params.py), for
every dense family, by the same roles:

- column-parallel, the output axis split: q (by whole heads), gate, up
  and their biases; k and v (and their biases) by kv heads (``kv_map``);
  an untied ``lm_head`` over the vocabulary, with its bias (phi). Scales
  follow the columns.
- row-parallel, the input axis split: o and down; the partial products
  are summed over the ranks (models/transformer.py). Their scales and
  biases replicate: a bias is added once, after the sum. In int4 these
  leaves are first repacked chunk-locally with ``tp`` chunks (ops/quant.py
  ``repack_int4_rows``) so that rank r's slice of the packed rows is a
  self-contained split-half pack of its own din rows; each keeps the
  ``chunked`` marker [tp, 0], as the JAX package replicates it.
- vocab-parallel: the embedding table (float, or int8 with its row
  scales). A tied head reads the rank's rows as its vocabulary columns.
- the q/k norms of kind "ln_head" and "rms_full" (per-head scales stored
  flat): cut with the heads, k's by ``kv_map``. The JAX package
  replicates them and slices inside its program; the port's rank holds
  only the heads it normalizes.
- everything else replicates: every other norm (bloom's embedding norm,
  gemma2's sandwich norms), "rms_head" scales, learned positions and
  opt-350m's projections.

Replicated kv heads (tp > Hkv, the JAX ``kv_head_axis``'s None): rank r
holds q heads [r·H/tp, (r+1)·H/tp). The kernels map local q head h to
local kv head h // (H_l / Hkv_l), so the rank keeps one kv head per run
of g = gcd(H/tp, H/Hkv) consecutive local q heads, all of which read the
same kv head: Hkv_l = (H/tp) / g kv heads per rank (``kv_map``). When tp
is a multiple of Hkv that is one kv head per rank; otherwise a kv head
can appear twice on a rank (H=12, Hkv=3, tp=4: rank 1's q heads 3, 4, 5
read kv heads 0, 1, 1 and it holds three, 0, 1, 1). Hkv_l = lcm(H/tp,
H/Hkv) / (H/Hkv) <= Hkv, so no rank holds more than the JAX package's
whole replicated kv heads; when tp divides Hkv the same rule gives the
plain cut, Hkv/tp contiguous heads.

Every shard is a fresh contiguous tensor, so the full leaf it came from
can be freed and a packed slice is aligned for the kernels.

Pipeline stages (``stage_keep``): stage p of pp holds layers
[p·L/pp, (p+1)·L/pp) whole, under their global names. Stage 0 holds the
embedding (table, learned positions, bloom's norm, opt-350m's
``project_in``); the last stage the final norm, ``project_out`` and the
head, and with a tied head a copy of the table. The JAX package shards
the stacked layer axis over pp (its ``param_specs``) and replicates the
rest; a stage here keeps only what its layers and its end of the model
read.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, List, Optional

import torch

from distributed_llm_inferencing_tpu_torch.ops.quant import repack_int4_rows
from distributed_llm_inferencing_tpu_torch.parallel.mesh import (
    MeshSpec, validate_spec)

COLUMN = ("q", "gate", "up")
KV = ("k", "v")
ROW = ("o", "down")
QK_NORMS = ("q_norm", "k_norm")
_LAYER = re.compile(r"^layers\.\d+\.(\w+)\.(\w+)$")


def kv_map(cfg, tp: int, rank: int) -> List[int]:
    """The global kv head of each of rank ``rank``'s local kv heads, in
    local order (the module docstring's rule)."""
    hl = cfg.num_heads // tp
    group = cfg.num_heads // cfg.num_kv_heads
    g = math.gcd(hl, group)
    return [(rank * hl + j * g) // group for j in range(hl // g)]


def kv_weights(cfg, tp: int, rank: int) -> List[float]:
    """1 / (how many local kv heads over all ranks copy each of this
    rank's local kv heads): the weight that makes a sum over every
    rank's kv heads count each global head once ("rms_full" k norms
    under replication)."""
    seen = Counter(h for r in range(tp) for h in kv_map(cfg, tp, r))
    return [1.0 / seen[h] for h in kv_map(cfg, tp, rank)]


def local_heads(cfg, spec: MeshSpec):
    """(q heads, kv heads) on one rank: H/tp and ``len(kv_map)``. The
    rank's KV cache and pool hold those kv heads (the JAX package's
    ``cache_specs``/``paged_cache_specs``, with its replication laid out
    per rank); one latent row under ``mla_latent_cache`` (tp=1 only)."""
    if spec.tp == 1:
        return cfg.num_heads, cfg.cache_kv_heads
    return cfg.num_heads // spec.tp, len(kv_map(cfg, spec.tp, 0))


def _role(name: str, cfg) -> Optional[str]:
    """column / kv / row / vocab, or None where the tensor replicates."""
    if name.startswith("embed.tokens"):
        return "vocab"
    if name.startswith("lm_head."):
        return "column"
    m = _LAYER.match(name)
    if m is None:
        return None
    leaf, kind = m.groups()
    if leaf in QK_NORMS:
        if cfg.qk_norm == "rms_head":
            return None
        return "column" if leaf == "q_norm" else "kv"
    if kind == "chunked":
        return None
    if leaf in COLUMN:
        return "column"
    if leaf in KV:
        return "kv"
    if leaf in ROW:
        return None if kind in ("scale", "b") else "row"
    return None


def split_dim(name: str, cfg) -> Optional[int]:
    """The dim of stored tensor ``name`` that tp splits, or None where it
    replicates."""
    role = _role(name, cfg)
    if role is None:
        return None
    if role in ("row", "vocab"):
        return 0
    kind = name.rsplit(".", 1)[1]
    return 0 if kind in ("scale", "b") else -1


def shard_tensor(name: str, t: torch.Tensor, cfg, spec: MeshSpec, rank: int,
                 repacked: bool = False) -> torch.Tensor:
    """Rank ``rank``'s shard of stored tensor ``name`` of ``cfg``. A
    row-parallel ``p4`` is repacked chunk-locally first, unless
    ``repacked``."""
    tp = spec.tp
    if tp == 1:
        return t
    if name.endswith(".p4") and _role(name, cfg) == "row" and not repacked:
        t = repack_int4_rows({"p4": t}, tp)["p4"]
    dim = split_dim(name, cfg)
    if dim is None:
        return t
    if _role(name, cfg) == "kv":
        hd = t.shape[dim] // cfg.num_kv_heads
        cols = torch.tensor([h * hd + i for h in kv_map(cfg, tp, rank)
                             for i in range(hd)], device=t.device)
        return t.index_select(dim % t.dim(), cols).contiguous()
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n).clone(
        memory_format=torch.contiguous_format)


def stage_range(cfg, spec: MeshSpec, stage: int) -> range:
    """The global indices of the layers pp stage ``stage`` holds."""
    n = cfg.num_layers // spec.pp
    return range(stage * n, (stage + 1) * n)


def stage_keep(cfg, spec: MeshSpec, stage: int):
    """Whether pp stage ``stage`` holds stored tensor ``name`` (a
    predicate on names; None at pp=1, where every rank holds all)."""
    if spec.pp == 1:
        return None
    layers = stage_range(cfg, spec, stage)
    first, last = stage == 0, stage == spec.pp - 1

    def keep(name: str) -> bool:
        if name.startswith("layers."):
            return int(name.split(".", 2)[1]) in layers
        if name.startswith("embed.tokens"):
            return first or (last and cfg.tie_word_embeddings)
        if name.startswith("embed.project_out"):
            return last
        if name.startswith("embed."):
            return first
        return last   # final_norm, lm_head
    return keep


def chunk_markers(cfg, spec: MeshSpec, device=None, layers=None
                  ) -> Dict[str, torch.Tensor]:
    """The ``chunked`` markers of the repacked row-parallel int4 leaves
    (of ``layers``, default every layer)."""
    if cfg.quant != "int4" or spec.tp == 1:
        return {}
    return {f"layers.{i}.{n}.chunked": torch.zeros(
        (spec.tp, 0), dtype=torch.int8, device=device)
        for i in (layers if layers is not None else range(cfg.num_layers))
        for n in ROW}


def shard_params(params: Dict[str, torch.Tensor], cfg, spec: MeshSpec,
                 rank: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s flat dict of a whole-model flat dict (a random
    init, or a tree bridged from the JAX package, chunked or not). A leaf
    already chunked for another tp raises ``ValueError``."""
    validate_spec(spec, cfg)
    if spec.tp == 1:
        return params
    out = {}
    for name, t in params.items():
        if name.endswith(".chunked"):
            continue
        marker = params.get(name.rsplit(".", 1)[0] + ".chunked")
        if marker is not None and marker.shape[-2] != spec.tp:
            raise ValueError(f"{name}: leaf chunked x{marker.shape[-2]}, "
                             f"served at tp={spec.tp}")
        out[name] = shard_tensor(name, t, cfg, spec, rank,
                                 repacked=marker is not None)
    out.update(chunk_markers(cfg, spec, next(iter(params.values())).device))
    return out
