"""Fused q projection -> RoPE -> paged flash decode: CUDA kernel, plain
version, and the routing gate.

Counterpart of the JAX package's ``ops/pallas/fused_decode.py``. The
unfused decode step runs the q projection, RoPE and paged attention as
separate kernels, so q makes a round trip through device memory between
them; ``fused_decode_step`` chains the three per (slot, kv head) in one
kernel (``csrc/fused_decode.cu``), with q kept on the SM.

- ``enabled`` / ``eligible`` / ``supported``: the same gate as the JAX
  package. ``DLI_FUSED_DECODE=1`` opts the serving decode step in; off by
  default, as there.
- ``rope_cos_sin`` / ``rope_rows``: per-slot cos/sin rows [R, hd] in
  the rotate-half layout with yarn's ``attn_factor`` folded in, from
  ops/rope's table.
- ``fused_decode_step(x, q_leaf, ...)``: the wrapper. ``q_leaf`` is the
  q projection's leaf as the JAX package has it, in any of its three
  forms: float ``{"w": [D, H*hd]}``, int8 ``{"q", "scale"}`` or int4
  ``{"p4", "scale"}`` (ops/quant.py layouts). The kernel reads a quantized
  tile in its stored form and makes the levels in registers; the plain
  version dequantizes and runs the float one.

The wrapper runs the plain version only for a CPU tensor; for a CUDA
tensor it launches the kernel or raises. ``launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

import torch

from distributed_llm_inferencing_tpu_torch.ops import build, rope
from distributed_llm_inferencing_tpu_torch.ops.flash_attention import (
    _DTYPE_CODE, _strides, _window)
from distributed_llm_inferencing_tpu_torch.ops.paged_attention import (
    check_paged_inputs, paged_flash_decode_ref)
from distributed_llm_inferencing_tpu_torch.ops.quant import (
    LEAF_KEYS, dequantize_weight, leaf_form, refuse_chunked)

_lib = None


def enabled() -> bool:
    """``DLI_FUSED_DECODE=1`` opts the serving decode step into the fused
    kernel (off by default, as in the JAX package)."""
    return os.environ.get("DLI_FUSED_DECODE", "0") not in ("0", "false", "")


def eligible(cfg, quantized_cache: bool) -> bool:
    """The one routing predicate of the serving decode step
    (models/transformer.py ``Transformer.paged_decode_step``). The port
    runs on one GPU, so the JAX gate's single-device clause always
    holds."""
    return enabled() and not quantized_cache and supported(cfg)


def supported(cfg, q_leaf=None) -> bool:
    """Static gate: the kernel implements the llama-family decode step —
    full-width non-interleaved RoPE (or no positional term on q), plain
    per-head attention over an unquantized paged pool, bias-free q
    projection. The same verdicts as the JAX package's ``supported``."""
    if cfg.mla or cfg.qk_norm or cfg.qkv_clip is not None:
        return False
    if cfg.attn_softcap is not None or cfg.attn_sinks:
        return False
    if cfg.position_embedding == "alibi" or cfg.attn_windows is not None:
        return False
    if cfg.position_embedding == "rope" and (
            cfg.rope_pct != 1.0 or cfg.rope_interleaved
            or cfg.rope_layers is not None):
        return False
    if cfg.v_head_dim_effective != cfg.head_dim:
        return False
    if cfg.kv_quant:
        return False
    if q_leaf is not None and "b" in q_leaf:
        return False
    return True


def rope_rows(cos_sin):
    """The kernel's per-slot rows from ops/rope's ``(cos, sin)`` for one
    position per slot ([R, 1, 1, hd/2] each): [R, hd] f32 in the
    rotate-half layout, where the two halves share the frequency
    ladder."""
    return tuple(torch.cat([t, t], dim=-1).reshape(t.shape[0], -1)
                 for t in cos_sin)


def rope_cos_sin(cfg, positions, head_dim: int):
    """Per-slot RoPE rows for the kernel: (cos, sin), each [R, hd] f32 in
    the rotate-half layout, yarn's attn_factor folded in. ``positions``
    [R] int."""
    return rope_rows(rope.rope_cos_sin(
        positions.long()[:, None], head_dim, cfg.rope_theta,
        cfg.rope_inv_freq, cfg.rope_attn_factor))


# weight form -> (the kernel's form code, stored dtype; None: x's)
_FORMS = {"float": (0, None), "int8": (1, torch.int8),
          "int4": (2, torch.uint8)}


def fused_decode_step_ref(x, q_leaf, k_pool, v_pool, block_tables,
                          context_lens, *, rope_cos=None, rope_sin=None,
                          sliding_window: Optional[int] = None):
    """Plain version of ``fused_decode_step``: f32 q projection (a
    quantized leaf dequantized first), the rotate-half rotation, then
    ``paged_flash_decode_ref`` on the f32 q."""
    w = (q_leaf["w"].float() if leaf_form(q_leaf) == "float"
         else dequantize_weight(q_leaf))
    R = x.shape[0]
    hd = k_pool.shape[-1]
    q = (x.float() @ w).reshape(R, -1, hd)                       # [R,H,hd]
    if rope_cos is not None:
        rot = torch.cat([-q[..., hd // 2:], q[..., :hd // 2]], dim=-1)
        q = q * rope_cos.float()[:, None] + rot * rope_sin.float()[:, None]
    out = paged_flash_decode_ref(q[:, None], k_pool, v_pool, block_tables,
                                 context_lens, sliding_window=sliding_window)
    return out[:, 0].to(x.dtype)


def _kernels():
    global _lib
    if _lib is None:
        lib = build.load("fused_decode")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dli_fused_decode_fwd.argtypes = (
            [P] * 10 + [I] * 8 + [P, F, I, P])
        lib.dli_fused_decode_fwd.restype = I
        _lib = lib
    return _lib


def fused_decode_step(x, q_leaf, k_pool, v_pool, block_tables, context_lens,
                      *, rope_cos=None, rope_sin=None,
                      sliding_window: Optional[int] = None):
    """One fused q projection + RoPE + paged-attention decode step.

    x [R, D] post-attention-norm hidden rows; ``q_leaf`` {"w": [D, H*hd]}
    in x's dtype, {"q": int8 [D, H*hd], "scale": f32 [H*hd]} or {"p4":
    uint8 [D/2, H*hd], "scale"}; k_pool/v_pool [NB,bs,Hkv,hd] already
    holding this token's K/V (the caller's ``write_token``); block_tables
    [R,MB] int32; context_lens [R] int32 (fill after this token's write);
    rope_cos/rope_sin [R, hd] f32 or None (no RoPE). Returns attn
    [R, H, hd] in x's dtype.
    """
    refuse_chunked(q_leaf)
    form = leaf_form(q_leaf)
    if x.device.type == "cpu":
        return fused_decode_step_ref(
            x, q_leaf, k_pool, v_pool, block_tables, context_lens,
            rope_cos=rope_cos, rope_sin=rope_sin,
            sliding_window=sliding_window)
    code, wdtype = _FORMS[form]
    w = q_leaf[LEAF_KEYS[form][0]]
    R, D = x.shape
    hd = k_pool.shape[-1]
    rows = D // 2 if form == "int4" else D
    if w.dim() != 2 or w.shape[0] != rows or w.shape[1] % hd \
            or (form == "int4" and D % 2):
        raise ValueError(f"fused_decode_step: {form} weight "
                         f"{tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)} and head_dim {hd}")
    H = w.shape[1] // hd
    check_paged_inputs("fused_decode_step", x, k_pool, v_pool, block_tables,
                       context_lens, H, hd)
    if block_tables.shape[0] != R or w.device != x.device \
            or w.dtype != (wdtype or x.dtype):
        raise ValueError("fused_decode_step: x, the weight and the tables "
                         "must agree on R and device, and the weight be "
                         f"{wdtype or x.dtype}")
    if D % 8 or any(t.stride(1) != 1 or t.stride(0) % 8 or t.data_ptr() % 16
                    for t in (x, w)):
        raise ValueError("fused_decode_step: x and the weight need D % 8 == "
                         "0, contiguous rows and 16-byte aligned row starts")
    wscale = None
    if form != "float":
        wscale = q_leaf["scale"]
        if (wscale.shape != (H * hd,) or wscale.dtype != torch.float32
                or wscale.device != x.device or not wscale.is_contiguous()):
            raise ValueError("fused_decode_step: scale must be [H*hd] "
                             "float32, contiguous, on x's device")
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("fused_decode_step: pass both rope_cos and rope_sin "
                         "or neither")
    if rope_cos is not None:
        for t in (rope_cos, rope_sin):
            if (t.shape != (R, hd) or t.dtype != torch.float32
                    or t.device != x.device or not t.is_contiguous()):
                raise ValueError("fused_decode_step: rope rows must be "
                                 "[R, hd] float32, contiguous, on x's device")
    window = _window(sliding_window)
    out = torch.empty((R, H, hd), dtype=x.dtype, device=x.device)
    cs = rope_cos if rope_cos is not None else x   # stride source only
    lib = _kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dli_fused_decode_fwd(
            x.data_ptr(), w.data_ptr(),
            None if wscale is None else wscale.data_ptr(),
            None if rope_cos is None else rope_cos.data_ptr(),
            None if rope_sin is None else rope_sin.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(),
            _DTYPE_CODE[x.dtype], code, R, D, H, k_pool.shape[2], hd,
            k_pool.shape[1],
            _strides((x, (0,)), (w, (0,)), (cs, (0,)), (block_tables, (0,)),
                     (k_pool, (0, 1, 2)), (v_pool, (0, 1, 2)),
                     (out, (0, 1))),
            1.0 / math.sqrt(hd), window, stream)
    build.check(lib, err, "fused_decode_step kernel launch")
    fused_decode_step.launches += 1
    return out


fused_decode_step.launches = 0
