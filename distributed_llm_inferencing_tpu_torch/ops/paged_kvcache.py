"""Paged KV cache: a pool of fixed-size blocks per layer, updated in place.

Counterpart of the JAX package's ``ops/paged_kvcache.py``:

- ``k``/``v``: [L, NB, bs, Hkv, hd] — NB blocks of bs positions per layer.
  Which blocks a sequence owns is host-side state (runtime/block_pool.py,
  with ref-counted radix prefix sharing).
- ``block_tables``: [R, MB] int32 — per serving slot, the block ids
  covering its sequence in order; ``context_lens`` [R] int32 — tokens
  cached per slot. Position p of a slot lives in
  ``block_tables[r, p // bs]`` at offset ``p % bs``.

Writes are in place (``index_put_`` into the pool): the JAX package
donates the pool to each jitted program so XLA updates it where it lies;
writing into the same tensors keeps one pool, never a copy per step. (On
the TPU a dynamic scatter cost enough that the JAX decode chunk batches
its writes through a side buffer; on the card an in-place write is a
small kernel, so the port writes every step.)

``paged_attend_decode`` is the decode regime: on a CUDA tensor it runs
the paged kernel (ops/paged_attention.py), on a CPU tensor its plain
version — except with ALiBi slopes, sinks or latent attention, which the
JAX package keeps off its Pallas paged kernel: those take
``gather_attend_decode``, the port of
the JAX package's XLA gather formulation, plain torch on every device
(no kernel, and no ``paged_flash_decode`` launch). ``paged_attend_prefix``
(a prompt tail attending its cached prefix plus itself) is plain torch on
every device, as in the JAX package, which computes it outside any Pallas
kernel.

The int8 pool (``cfg.kv_quant == "int8"``) holds int8 ``k``/``v`` and
per-(token, head) f32 scales ``k_scale``/``v_scale`` [L, NB, bs, Hkv]
(ops/kvcache.py ``quant_kv``). It always decodes through
``gather_attend_decode``, dequantizing the gathered blocks, and never
through ``paged_flash_decode``, as the JAX package routes it (its Pallas
paged kernel has no int8 rule); ``paged_attend_prefix`` dequantizes the
gathered prefix.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig
from distributed_llm_inferencing_tpu_torch.ops.flash_attention import (
    masked_attention)
from distributed_llm_inferencing_tpu_torch.ops.kvcache import dequant_kv
from distributed_llm_inferencing_tpu_torch.ops.paged_attention import (
    paged_flash_decode)
from distributed_llm_inferencing_tpu_torch.utils.device import torch_dtype


@dataclasses.dataclass
class PagedKVCache:
    k: torch.Tensor   # [L, NB, bs, Hkv, hd] (model dtype, or int8)
    v: torch.Tensor   # [L, NB, bs, Hkv, hd]
    # per-token-per-head scales, present iff cfg.kv_quant == "int8":
    # [L, NB, bs, Hkv] f32
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def leaves(self):
        """The pool's tensors, each [L, NB, bs, ...] (k, v, then the
        scales of an int8 pool): what a block's pages are cut from."""
        return [t for t in (self.k, self.v, self.k_scale, self.v_scale)
                if t is not None]

    def layer(self, i: int):
        """Layer i's views (k, v, k_scale, v_scale), the scales None
        for a native pool."""
        return tuple(None if t is None else t[i]
                     for t in (self.k, self.v, self.k_scale, self.v_scale))


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=None, device=None,
                     num_kv_heads=None, num_layers=None) -> PagedKVCache:
    """A zeroed pool; ``num_kv_heads`` is a tp rank's kv heads
    (parallel/sharding.py ``local_heads``: the ones its q heads read, the
    JAX package's ``paged_cache_specs``), all of them by default, and
    ``num_layers`` a pp stage's layers. An int8 pool's per-(token, head)
    scales follow the heads."""
    dtype = torch_dtype(dtype or cfg.dtype)
    shape = (num_layers or cfg.num_layers, num_blocks, block_size,
             num_kv_heads or cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_quant == "int8":
        return PagedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device))
    if cfg.kv_quant is not None:
        raise ValueError(f"unknown kv_quant mode {cfg.kv_quant!r}")
    # zeroed, as the reference: the plain attention multiplies unread
    # slots by probability 0, which must not meet uninitialised NaNs
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                        v=torch.zeros(shape, dtype=dtype, device=device))


def write_token(cache_layer, new, block_tables, positions):
    """Write one new token per slot into a layer's pool, in place.

    cache_layer [NB,bs,Hkv,hd]; new [R,Hkv,hd]; block_tables [R,MB];
    positions [R] — the position being written. Returns cache_layer."""
    bs = cache_layer.shape[1]
    pos = positions.long()
    blk = torch.gather(block_tables.long(), 1, (pos // bs)[:, None])[:, 0]
    cache_layer[blk, pos % bs] = new.to(cache_layer.dtype)
    return cache_layer


def write_block_run(cache_layer, new_blocks, block_ids):
    """Write runs of whole blocks (prefilled tails) into the pool, in place.

    cache_layer [NB,bs,Hkv,hd]; new_blocks [B,T,Hkv,hd] with T a multiple
    of bs; block_ids [B, T // bs]. Duplicate ids occur only on the
    reserved dummy block (padding rows), whose contents are never read.
    Returns cache_layer."""
    bs = cache_layer.shape[1]
    b, t = new_blocks.shape[:2]
    cache_layer[block_ids.reshape(-1).long()] = new_blocks.reshape(
        b * (t // bs), bs, *new_blocks.shape[2:]).to(cache_layer.dtype)
    return cache_layer


def gather_seq(cache_layer, block_tables):
    """[NB,bs,Hkv,hd] + [R,MB] -> contiguous [R, MB*bs, Hkv, hd]."""
    r, mb = block_tables.shape
    g = cache_layer[block_tables.long()]               # [R,MB,bs,Hkv,hd]
    return g.reshape(r, mb * cache_layer.shape[1], *cache_layer.shape[2:])


def gather_attend_decode(q, cache_k_layer, cache_v_layer, block_tables,
                         context_lens, sliding_window: Optional[int] = None,
                         alibi=None, softcap: Optional[float] = None,
                         k_scale_layer=None, v_scale_layer=None,
                         sinks=None):
    """Single-token attention over the pool by the JAX package's XLA
    formulation (its ``paged_attend_decode`` off the Pallas kernel): each
    slot's blocks gathered into a contiguous [R, MB*bs, Hkv, hd] copy
    (an int8 pool's dequantized to q's dtype with its gathered scales),
    then the plain masked attention with the query at ``context_lens -
    1``. Plain torch on every device; the route of the ALiBi families, of
    the int8 pool, of sinks and of latent attention's padded pool."""
    r, mb = block_tables.shape
    k = gather_seq(cache_k_layer, block_tables)
    v = gather_seq(cache_v_layer, block_tables)
    if k_scale_layer is not None:
        k = dequant_kv(k, gather_seq(k_scale_layer, block_tables), q.dtype)
        v = dequant_kv(v, gather_seq(v_scale_layer, block_tables), q.dtype)
    kv_pos = torch.arange(k.shape[1], device=q.device).expand(r, -1)
    lens = context_lens.long()
    return masked_attention(q, k, v, (lens - 1)[:, None], kv_pos,
                            kv_pos < lens[:, None], sliding_window, alibi,
                            softcap=softcap, sinks=sinks)


def paged_attend_decode(q, cache_k_layer, cache_v_layer, block_tables,
                        context_lens, sliding_window: Optional[int] = None,
                        alibi=None, softcap: Optional[float] = None,
                        k_scale_layer=None, v_scale_layer=None,
                        sinks=None, plain: bool = False):
    """The decode regime: q [R,1,H,hd] against the pool, ``context_lens``
    counting the token just written. The paged kernel on CUDA (its plain
    version on the CPU), softcap included; with ``alibi`` slopes [H], an
    int8 pool's scales, ``sinks`` [H] or ``plain`` (latent attention)
    the gather formulation, where the JAX package routes them too."""
    if (alibi is not None or k_scale_layer is not None
            or sinks is not None or plain):
        return gather_attend_decode(q, cache_k_layer, cache_v_layer,
                                    block_tables, context_lens,
                                    sliding_window, alibi, softcap,
                                    k_scale_layer, v_scale_layer, sinks)
    return paged_flash_decode(q, cache_k_layer, cache_v_layer, block_tables,
                              context_lens, sliding_window=sliding_window,
                              softcap=softcap)


def paged_attend_prefix(q, k_new, v_new, cache_k_layer, cache_v_layer,
                        prefix_blocks, prefix_len, q_positions, tail_valid,
                        sliding_window: Optional[int] = None, alibi=None,
                        softcap: Optional[float] = None,
                        k_scale_layer=None, v_scale_layer=None,
                        sinks=None):
    """Tail-prefill attention: fresh tail K/V plus a cached prefix, whose
    K/V is gathered from the shared blocks — a prefix-cache hit saves the
    prefix's compute, not just its memory. An int8 pool's prefix is
    dequantized to q's dtype; the tail attends its own fresh K/V.

    q, k_new, v_new [B,T,...] fresh tail projections; prefix_blocks [B,PB]
    (dummy-padded); prefix_len [B] real cached tokens; q_positions [B,T]
    absolute positions (prefix_len + i); tail_valid [B,T] rows holding
    real tokens; ``alibi`` [H] f32 slopes or None."""
    b = q.shape[0]
    kp = gather_seq(cache_k_layer, prefix_blocks)     # [B, PB*bs, Hkv, hd]
    vp = gather_seq(cache_v_layer, prefix_blocks)
    if k_scale_layer is not None:
        kp = dequant_kv(kp, gather_seq(k_scale_layer, prefix_blocks),
                        q.dtype)
        vp = dequant_kv(vp, gather_seq(v_scale_layer, prefix_blocks),
                        q.dtype)
    p = kp.shape[1]
    prefix_pos = torch.arange(p, device=q.device).expand(b, p)
    prefix_valid = prefix_pos < prefix_len.long()[:, None]
    k_all = torch.cat([kp, k_new.to(kp.dtype)], dim=1)
    v_all = torch.cat([vp, v_new.to(vp.dtype)], dim=1)
    kv_pos = torch.cat([prefix_pos, q_positions.long()], dim=1)
    kv_valid = torch.cat([prefix_valid, tail_valid], dim=1)
    return masked_attention(q, k_all, v_all, q_positions.long(), kv_pos,
                            kv_valid, sliding_window, alibi,
                            softcap=softcap, sinks=sinks)
