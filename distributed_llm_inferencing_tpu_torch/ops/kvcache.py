"""Static-shape dense KV cache, updated in place.

- ``k``/``v``: [L, B, max_seq, Hkv, hd] stacked over layers; layer ``i``
  reads and writes the view ``k[i]``. Under ``cfg.mla_latent_cache``
  (the engine's MLA layout, the reference's) ``k`` is [L, B, max_seq, 1,
  qk_rope_head_dim + kv_lora_rank], one shared latent row per token, and
  ``v`` is zero-width.
- ``lengths``: [B] int32 on the cache's device — filled slots per
  sequence (the same for every layer).
- ``k_scale``/``v_scale``: [L, B, max_seq, Hkv] f32, present only under
  ``cfg.kv_quant == "int8"``: ``k``/``v`` then hold int8 levels with one
  symmetric scale per (token, head) (``quant_kv``), about half the bf16
  cache's bytes. Reads dequantize (``dequant_kv``) and attend through
  the plain attention, as in the JAX package, whose XLA fuses the
  dequantize into its attention matmul; no kernel has an int8 arm.

Writes are in place: the reference's engine donates its cache buffers to
each jitted step (its runtime/engine.py, prefill and decode programs), so
XLA updates them where they lie; writing into the same tensors here keeps
the same memory footprint — one cache, never a copy per step.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig
from distributed_llm_inferencing_tpu_torch.utils.device import torch_dtype


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor         # [L, B, S, Hkv, hd] (model dtype, or int8)
    v: torch.Tensor         # [L, B, S, Hkv, hd]
    lengths: torch.Tensor   # [B] int32
    k_scale: Optional[torch.Tensor] = None   # [L, B, S, Hkv] f32 (int8)
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def layer(self, i: int):
        """Layer i's views (k, v, k_scale, v_scale), the scales None for
        a native cache."""
        return tuple(None if t is None else t[i]
                     for t in (self.k, self.v, self.k_scale, self.v_scale))


def quant_kv(x):
    """[..., Hkv, hd] -> (int8 [..., Hkv, hd], f32 scale [..., Hkv]):
    symmetric per (token, head), the JAX package's ``quant_kv`` step for
    step (``torch.round`` rounds half to even, as ``jnp.round``)."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1).clamp(min=1e-8) / 127.0
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequant_kv(q, scale, dtype):
    """Inverse of ``quant_kv``: f32 levels times their scale, cast to
    ``dtype``."""
    return (q.float() * scale[..., None].float()).to(dtype)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None, num_kv_heads=None, num_layers=None) -> KVCache:
    """A zeroed cache; ``num_kv_heads`` is a tp rank's share of the kv
    heads (parallel/sharding.py ``local_heads``), all of them by
    default; ``num_layers`` a pp stage's layers, all by default
    (``max_seq``: an sp rank's slice of the positions)."""
    dtype = torch_dtype(dtype or cfg.dtype)
    # mla_latent_cache: one shared [k_rot | c] row per token in the k
    # plane ([L, B, S, 1, rd + r]) and a zero-width v plane
    shape = (num_layers or cfg.num_layers, batch, max_seq,
             num_kv_heads or cfg.cache_kv_heads, cfg.cache_head_dim)
    vshape = shape[:-1] + (cfg.cache_v_head_dim,)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=device)
    if cfg.kv_quant == "int8":
        z = functools.partial(torch.zeros, device=device)
        return KVCache(k=z(shape, dtype=torch.int8),
                       v=z(vshape, dtype=torch.int8), lengths=lengths,
                       k_scale=z(shape[:-1], dtype=torch.float32),
                       v_scale=z(shape[:-1], dtype=torch.float32))
    if cfg.kv_quant is not None:
        raise ValueError(f"unknown kv_quant mode {cfg.kv_quant!r}")
    # zeroed, as the reference: the plain attention multiplies unused
    # slots by probability 0, which must not meet uninitialised NaNs
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(vshape, dtype=dtype, device=device), lengths=lengths)


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
