"""Attention: the plain formulation and the dispatch to the kernels.

- ``attend``: causal attention over a (possibly cached, possibly padded)
  KV set with GQA, static window and ALiBi, in plain PyTorch — the port
  of the reference's XLA formulation; the same code
  (``flash_attention.masked_attention``) is the kernels' plain version.
- ``attend_prefill`` / ``attend_decode``: the two regimes of the serving
  path. They pick by tensor device, not by a backend flag: a CUDA tensor
  goes to the hand-written kernel (ops/flash_attention.py), a CPU tensor
  to the kernel's plain version. The score softcap (gemma2) runs in the
  kernels' cap arm. Sinks (gpt-oss) and ``plain`` (latent attention,
  whose 192-wide heads and zero-padded v the JAX package keeps off its
  kernels: ``_cfg_backend``) take the plain formulation on every device,
  as the JAX package routes them; so does an int8 cache's decode.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from distributed_llm_inferencing_tpu_torch.ops.flash_attention import (
    flash_attention, flash_decode, masked_attention)
from distributed_llm_inferencing_tpu_torch.ops.kvcache import dequant_kv


def alibi_slopes(num_heads: int, device=None):
    """Per-query-head ALiBi slopes, HF convention (geometric from the
    nearest power of two, odd-index extras interpolated). [H] f32; the
    bias applied is ``slope * (kv_pos - q_pos)``."""
    cp2 = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(cp2) - 3)))
    slopes = [base ** (i + 1) for i in range(cp2)]
    if cp2 != num_heads:
        extra = 2.0 ** (-(2.0 ** -(math.log2(2 * cp2) - 3)))
        slopes += [extra ** (2 * i + 1) for i in range(num_heads - cp2)]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def attend(q, k, v, q_positions, kv_positions, kv_valid,
           sliding_window: Optional[int] = None, alibi=None,
           softcap: Optional[float] = None, sinks=None,
           scale: Optional[float] = None):
    """Causal attention: query at position p attends kv at position t iff
    t <= p, the slot is valid, and (no window or p - t < window).

    q [B,Sq,H,hd]; k/v [B,Skv,Hkv,hd]; q_positions [B,Sq];
    kv_positions/kv_valid [B,Skv]. Works for prefill and decode alike.
    The reference's formulation, except that a row with no admissible key
    yields 0 (as the kernels do) instead of an average over masked slots.
    """
    return masked_attention(q, k, v, q_positions, kv_positions, kv_valid,
                            sliding_window, alibi, scale, softcap, sinks)


def attend_prefill(q, k, v, *, sliding_window: Optional[int] = None,
                   alibi=None, softcap: Optional[float] = None, sinks=None,
                   plain: bool = False):
    """Causal self-attention over the fresh (uncached) K/V block: the
    prefill kernel on CUDA, its plain version on the CPU; the plain
    formulation on every device with ``sinks`` [H] or ``plain``."""
    if sinks is not None or plain:
        B, S = q.shape[:2]
        pos = torch.arange(S, device=q.device).expand(B, S)
        return masked_attention(
            q, k, v, pos, pos,
            torch.ones(B, S, dtype=torch.bool, device=q.device),
            sliding_window, alibi, softcap=softcap, sinks=sinks)
    return flash_attention(q, k, v, sliding_window=sliding_window,
                           alibi=alibi, softcap=softcap)


def attend_decode(q, cache_k, cache_v, lengths, *,
                  sliding_window: Optional[int] = None, alibi=None,
                  softcap: Optional[float] = None, sinks=None,
                  k_scale=None, v_scale=None, q_positions=None,
                  plain: bool = False, scale: Optional[float] = None):
    """Cached attention for decode-regime queries. Single-token: ``lengths``
    counts filled slots including the token just written; the query sits
    at ``lengths - 1``. Multi-token (speculative verification,
    ops/speculative.py ``verify_step``): ``q_positions`` [B, Sq] masks
    each query causally at its own position, by the plain formulation,
    as the JAX package does (its flash-decode kernel takes one query).
    An int8 cache (``k_scale``/``v_scale`` [B,S,Hkv] given) is
    dequantized to q's dtype and attended by the plain formulation, where
    the JAX package pins a quantized cache (its XLA fuses the dequantize
    into the attention matmul); no ``flash_decode`` launch. ``sinks``,
    ``plain`` and a ``scale`` (MLA's latent decode: the materialized
    head_dim's) take the plain formulation too."""
    multi = q.shape[1] != 1
    if multi and q_positions is None:
        raise ValueError("a multi-token decode needs q_positions")
    if (k_scale is not None or multi or plain or sinks is not None
            or scale is not None):
        k, v = cache_k, cache_v
        if k_scale is not None:
            k = dequant_kv(cache_k, k_scale, q.dtype)
            v = dequant_kv(cache_v, v_scale, q.dtype)
        B, S = k.shape[:2]
        kv_pos = torch.arange(S, device=q.device).expand(B, S)
        lens = lengths.long()
        q_pos = (q_positions.long() if q_positions is not None
                 else (lens - 1)[:, None])
        return masked_attention(q, k, v, q_pos, kv_pos,
                                kv_pos < lens[:, None], sliding_window,
                                alibi, scale, softcap, sinks)
    return flash_decode(q, cache_k, cache_v, lengths,
                        sliding_window=sliding_window, alibi=alibi,
                        softcap=softcap)
