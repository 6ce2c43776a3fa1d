"""Static-shape dense KV cache, updated in place.

- ``k``/``v``: [L, B, max_seq, Hkv, hd] stacked over layers; layer ``i``
  reads and writes the view ``k[i]``.
- ``lengths``: [B] int32 on the cache's device — filled slots per
  sequence (the same for every layer).

Writes are in place: the reference's engine donates its cache buffers to
each jitted step (its runtime/engine.py, prefill and decode programs), so
XLA updates them where they lie; writing into the same tensors here keeps
the same memory footprint — one cache, never a copy per step. The int8
cache mode (``kv_quant``) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig
from distributed_llm_inferencing_tpu_torch.utils.device import torch_dtype


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor         # [L, B, S, Hkv, hd]
    v: torch.Tensor         # [L, B, S, Hkv, hd]
    lengths: torch.Tensor   # [B] int32

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None, num_kv_heads=None) -> KVCache:
    """A zeroed cache; ``num_kv_heads`` is a tp rank's share of the kv
    heads (parallel/sharding.py ``local_heads``), all of them by
    default."""
    if cfg.kv_quant is not None:
        raise NotImplementedError("int8 KV cache is not ported yet")
    dtype = torch_dtype(dtype or cfg.dtype)
    shape = (cfg.num_layers, batch, max_seq,
             num_kv_heads or cfg.num_kv_heads, cfg.head_dim)
    # zeroed, as the reference: the plain attention multiplies unused
    # slots by probability 0, which must not meet uninitialised NaNs
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device))


def block_slots(starts, s: int, max_seq: int):
    """[B, s] cache slots of an s-token block starting at ``starts`` [B],
    with the reference's dynamic_update_slice clamp (a block never runs
    past capacity; the engine keeps sequences inside max_seq)."""
    st = starts.to(torch.int64).clamp(0, max_seq - s)
    return st[:, None] + torch.arange(s, device=starts.device)


def write_block(cache_layer, new, starts, slots=None):
    """Write ``new`` [B,s,Hkv,hd] into ``cache_layer`` [B,S,Hkv,hd] at
    per-sequence slots ``starts`` [B], in place, with no host sync (the
    starts stay on the device). ``slots`` takes a precomputed
    ``block_slots`` so a forward computes them once for all layers.
    Returns ``cache_layer``."""
    B, s = new.shape[:2]
    if slots is None:
        slots = block_slots(starts, s, cache_layer.shape[1])
    rows = torch.arange(B, device=cache_layer.device)[:, None]
    cache_layer[rows, slots] = new.to(cache_layer.dtype)
    return cache_layer
