"""Which part of each weight a tp rank holds (megatron-style).

The JAX package's ``parallel/sharding.py`` assigns a ``PartitionSpec`` per
leaf and lets GSPMD place the shards; here each rank cuts its own shard
out of the port's flat dict (models/params.py), for the llama arm:

- q, k, v, gate, up: column-parallel, the output axis split (q and k/v by
  whole heads); their scales follow the columns.
- o, down: row-parallel, the input axis split; the partial products are
  summed over the ranks (models/transformer.py). Scales replicate. In
  int4 these leaves are first repacked chunk-locally with ``tp`` chunks
  (ops/quant.py ``repack_int4_rows``) so that rank r's slice of the
  packed rows is a self-contained split-half pack of its own din rows;
  each keeps the ``chunked`` marker [tp, 0], as the JAX package
  replicates it.
- the embedding table (float, or int8 with its row scales): the vocabulary
  split; lm_head: column-parallel over the vocabulary.
- norms: replicated.

Every shard is a fresh contiguous tensor, so the full leaf it came from
can be freed and a packed slice is aligned for the kernels.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch

from distributed_llm_inferencing_tpu_torch.ops.quant import repack_int4_rows
from distributed_llm_inferencing_tpu_torch.parallel.mesh import (
    MeshSpec, validate_spec)

COLUMN = ("q", "k", "v", "gate", "up")
ROW = ("o", "down")
_LAYER = re.compile(r"^layers\.\d+\.(\w+)\.\w+$")


def _role(name: str) -> Optional[str]:
    if name.startswith("embed.tokens"):
        return "vocab"
    if name.startswith("lm_head."):
        return "column"
    m = _LAYER.match(name)
    if m and m.group(1) in COLUMN:
        return "column"
    if m and m.group(1) in ROW:
        return "row"
    return None


def split_dim(name: str) -> Optional[int]:
    """The dim of stored tensor ``name`` that tp splits, or None where it
    replicates."""
    role, kind = _role(name), name.rsplit(".", 1)[1]
    if role is None or kind == "chunked":
        return None
    if role == "row":
        return None if kind == "scale" else 0
    if role == "column" and kind == "scale":
        return 0                                  # [dout]
    return 0 if role == "vocab" else -1


def shard_tensor(name: str, t: torch.Tensor, spec: MeshSpec, rank: int,
                 repacked: bool = False) -> torch.Tensor:
    """Rank ``rank``'s shard of stored tensor ``name``. A row-parallel
    ``p4`` is repacked chunk-locally first, unless ``repacked``."""
    tp = spec.tp
    if tp == 1:
        return t
    if name.endswith(".p4") and _role(name) == "row" and not repacked:
        t = repack_int4_rows({"p4": t}, tp)["p4"]
    dim = split_dim(name)
    if dim is None:
        return t
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n).clone(
        memory_format=torch.contiguous_format)


def chunk_markers(cfg, spec: MeshSpec, device=None
                  ) -> Dict[str, torch.Tensor]:
    """The ``chunked`` markers of the repacked row-parallel int4 leaves."""
    if cfg.quant != "int4" or spec.tp == 1:
        return {}
    return {f"layers.{i}.{n}.chunked": torch.zeros(
        (spec.tp, 0), dtype=torch.int8, device=device)
        for i in range(cfg.num_layers) for n in ROW}


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
        out[name] = shard_tensor(name, t, spec, rank,
                                 repacked=marker is not None)
    out.update(chunk_markers(cfg, spec, next(iter(params.values())).device))
    return out


def local_heads(cfg, spec: MeshSpec):
    """(q heads, kv heads) on one rank: the rank's share of each. The
    rank's KV cache holds its kv heads (the JAX package's
    ``cache_specs``): one latent row under ``mla_latent_cache``."""
    return cfg.num_heads // spec.tp, cfg.cache_kv_heads // spec.tp
