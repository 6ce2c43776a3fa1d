"""int4 weight-only matmul: the ``q4_matmul`` and ``q4_matmul_row`` CUDA
kernels, their plain versions, the gate and the linear's dispatch.

Counterpart of the JAX package's ``ops/pallas/quant_matmul.py``. The
kernel (``csrc/quant_matmul.cu``) computes ``x [b, din] @ unpack(p4
[din/2, dout]) * scale [dout]`` with the split-half packing of
ops/quant.py, unpacking the nibbles in registers: the unpacked weight
never reaches device memory, so a decode step reads half a byte per
weight.

- ``supported(rows, din, dout)``: the gate. Decode-shaped calls (rows <=
  ``MAX_PALLAS_ROWS`` = 32, the JAX package's bound) go to the kernel;
  prefill-sized ones take the plain unpack, where one unpacked weight
  serves many rows. The JAX thresholds ``din // 2 >= 32`` and ``dout >=
  128`` came from the TPU's (8, 128) tiling; the CUDA kernel's own
  constraints replace them: an even ``din`` (split-half packing) and
  ``dout % 8 == 0`` (each thread reads 8 neighbouring columns of a packed
  row in one 8-byte load).
- ``q4_matmul(x, p4, scale)``: the kernel's wrapper; ``launches`` counts
  its launches. f32 products and sums, times the f32 scale, one rounding
  to x's dtype (the JAX kernel's numerics).
- ``q4_matmul_row(x, p4, scale, chunks)``: the same kernel over the
  chunk-local layout of the row-parallel leaves (ops/quant.py
  ``repack_int4_rows``); its own ``launches``. A tp rank calls it on its
  one chunk (``chunks = 1``) and sums the partials across ranks (the
  JAX package's per-shard kernel plus ``psum``); one device holding the
  whole chunked leaf calls it with all ``chunks``.
- ``q4_matmul_ref`` / ``q4_matmul_row_ref``: the plain versions: unpack,
  f32 matmul, times scale, one rounding.
- Two kernel forms, picked by ``q4_form`` from x's dtype: "mma" (bf16: the
  products on the tensor cores) and "simt" (f32: on the CUDA cores).
  ``launches_mma`` on each wrapper counts its tensor-core launches;
  ``mma_slot_rows`` / ``q4_matmul_mma_model`` are the tensor-core form's
  k-slot map and arithmetic in plain PyTorch.
- ``q4_linear(x, leaf, shards)``: an int4 linear with any leading dims
  on x. Decode-shaped calls take a kernel (``q4_matmul_row`` for a
  chunked leaf, of which this rank holds ``1/shards``); the rest unpack
  and run ``torch.matmul`` in x's dtype, then ``* scale.to(x.dtype)``
  (the product the JAX package leaves to XLA). The two routes round
  differently in bf16.

The wrappers run the plain version only for a CPU tensor; for a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from distributed_llm_inferencing_tpu_torch.ops import build, launches
from distributed_llm_inferencing_tpu_torch.ops.flash_attention import (
    _DTYPE_CODE)
from distributed_llm_inferencing_tpu_torch.ops.quant import (
    pack_chunks, unpack_int4)

MAX_PALLAS_ROWS = 32
_TILE_N = 256          # columns per block (csrc/quant_matmul.cu kTileN)
_ROWS_PER_BLOCK = 8    # x rows per block (kRowsMax)
_MIN_SPLIT_ROWS = 64   # packed rows per contraction split, at least
_MMA_COLS = 128        # columns per block of the tensor-core form (kMmaCols)
_MMA_STEP = 8          # packed rows per k-step (kStepRows)
_MMA_MIN_SPLIT = 256   # packed rows per contraction split, at least
_MMA_MAX_SPLIT = 8     # contraction splits, at most (kMmaMaxSplit)
_lib = None


def supported(rows: int, din: int, dout: int) -> bool:
    """Gate of the kernel route (see the module note)."""
    return 1 <= rows <= MAX_PALLAS_ROWS and din % 2 == 0 and din >= 2 \
        and dout % 8 == 0 and dout >= 8


def ksplit(rows: int, din: int, dout: int, sms: int) -> int:
    """How many blocks share the contraction: enough for about two
    blocks per SM, each with at least ``_MIN_SPLIT_ROWS`` packed rows."""
    blocks = -(-dout // _TILE_N) * -(-rows // _ROWS_PER_BLOCK)
    half = din // 2
    want = -(-2 * sms // blocks)
    ks = max(1, min(want, half // _MIN_SPLIT_ROWS))
    return -(-half // -(-half // ks))


def q4_form(dtype, rows: int) -> str:
    """Which kernel takes a call: "mma" (tensor cores) for bf16 x, "simt"
    (CUDA cores, f32 products) for f32 x, whose f32 cross-checks TF32 or
    bf16 products would change. From dtype alone, never by a failure."""
    return "mma" if dtype == torch.bfloat16 else "simt"


def mma_split(rows: int, din: int, dout: int, sms: int):
    """The tensor-core form's contraction split: (packed rows per split, a
    multiple of its 8-row k-step; splits, at most ``_MMA_MAX_SPLIT``, the
    blocks of one cluster). Enough splits for about two blocks per SM,
    each with at least ``_MMA_MIN_SPLIT`` packed rows."""
    half = din // 2
    blocks = -(-dout // _MMA_COLS)
    ks = max(1, min(-(-2 * sms // blocks), half // _MMA_MIN_SPLIT,
                    _MMA_MAX_SPLIT))
    kchunk = -(-(-(-half // ks)) // _MMA_STEP) * _MMA_STEP
    return kchunk, -(-half // kchunk)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def q4_matmul_ref(x, p4, scale):
    """Plain version: unpack, f32 matmul, times the f32 scale, one
    rounding to x's dtype."""
    return q4_matmul_row_ref(x, p4, scale, 1)


def q4_matmul_row_ref(x, p4, scale, chunks: int):
    """Plain version of ``q4_matmul_row``: the chunk-aware unpack, f32
    matmul, times the f32 scale, one rounding to x's dtype."""
    w = unpack_int4(p4, chunks).float()
    return ((x.float() @ w) * scale.float()).to(x.dtype)


def mma_slot_rows(din: int, chunks: int = 1):
    """The tensor-core form's k-slot map: [k-steps, 16] din rows. k-step
    s takes packed rows 8s .. 8s+7; slot j < 8 is the low nibble of packed
    row 8s+j (din row lo = row + (row // ch) * ch, ch = din / (2 *
    chunks)), slot 8+j its high nibble (din row lo + ch); -1 past the
    contraction (zero-filled in the kernel)."""
    half = din // 2
    ch = half // chunks
    steps = -(-half // _MMA_STEP)
    row = torch.arange(steps * _MMA_STEP)
    lo = row + (row // ch) * ch
    live = row < half
    slots = torch.cat([torch.where(live, lo, -1).reshape(steps, _MMA_STEP),
                       torch.where(live, lo + ch, -1)
                       .reshape(steps, _MMA_STEP)], 1)
    return slots


def q4_matmul_mma_model(x, p4, scale, chunks: int = 1):
    """The tensor-core form's arithmetic in plain PyTorch: levels made as
    the kernel makes them (the nibble in the mantissa of bf16 128, minus
    136), A [k-step, 16 slots, dout] with the low nibbles of 8 packed rows
    on slots 0-7 and their high nibbles on 8-15, B [b, k-step, 16] the x
    values ``mma_slot_rows`` names, f32 sums, times the f32 scale, one
    rounding to x's dtype."""
    half, dout = p4.shape
    slots = mma_slot_rows(2 * half, chunks)
    steps = slots.shape[0]
    rows = torch.arange(steps * _MMA_STEP).clamp(max=half - 1)
    nib = p4[rows].to(torch.int32)                       # [steps*8, dout]
    level = lambda n: ((n | 0x4300).to(torch.int16)     # noqa: E731
                       .view(torch.bfloat16).float() - 136.0)
    a = torch.cat([level(nib & 15).reshape(steps, _MMA_STEP, dout),
                   level(nib >> 4).reshape(steps, _MMA_STEP, dout)], 1)
    xf = x.float()
    xb = torch.where(slots >= 0, xf[:, slots.clamp(min=0)],
                     torch.zeros((), dtype=torch.float32))  # [b, steps, 16]
    out = torch.einsum("bsk,skd->bd", xb, a)
    return (out * scale.float()).to(x.dtype)


def _kernels():
    global _lib
    if _lib is None:
        lib = build.load("quant_matmul")
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dli_q4_matmul.argtypes = [P] * 5 + [I] * 4 + [LL, LL, I, I, P]
        lib.dli_q4_matmul.restype = I
        lib.dli_q4_matmul_mma.argtypes = ([P] * 4 + [I] * 3
                                          + [LL, LL, I, I, I, P])
        lib.dli_q4_matmul_mma.restype = I
        _lib = lib
    return _lib


def _launch(name, x, p4, scale, chunks):
    """Check the inputs and launch the kernel of ``q4_form`` (``chunks``
    chunk-local split-half packs; 1 is the global layout). Returns
    ([b, dout], whether the tensor-core form ran)."""
    if x.dim() != 2 or p4.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"{name}: x {tuple(x.shape)}, p4 "
                         f"{tuple(p4.shape)}, scale {tuple(scale.shape)}")
    b, din = x.shape
    dout = p4.shape[1]
    if x.dtype not in _DTYPE_CODE or p4.dtype != torch.uint8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"{name}: takes float32/bfloat16 x, uint8 p4, "
                        f"float32 scale; got {x.dtype}/{p4.dtype}/"
                        f"{scale.dtype}")
    if not supported(b, din, dout) or p4.shape[0] * 2 != din \
            or scale.shape[0] != dout or chunks < 1 or din % (2 * chunks):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, p4 "
                         f"{tuple(p4.shape)}, scale {tuple(scale.shape)}, "
                         f"{chunks} chunks outside the kernel (see "
                         "supported())")
    if not all(t.is_cuda and t.device == x.device for t in (p4, scale)):
        raise ValueError(f"{name}: x, p4 and scale must lie on one CUDA "
                         "device")
    if x.stride(1) != 1 or not p4.is_contiguous() or p4.data_ptr() % 8 \
            or not scale.is_contiguous():
        raise ValueError(f"{name}: x needs a contiguous last dim; p4 and "
                         "scale must be contiguous, p4 8-byte aligned")
    mma = q4_form(x.dtype, b) == "mma"
    sms = _sm_count(x.device.index)
    out = torch.empty((b, dout), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), p4.data_ptr(), scale.data_ptr(), out.data_ptr())
    lib = _kernels()
    if mma:
        kchunk, ks = mma_split(b, din, dout, sms)
    else:
        ks = ksplit(b, din, dout, sms)
        part = (torch.empty((ks, b, dout), dtype=torch.float32,
                            device=x.device) if ks > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if mma:
            err = lib.dli_q4_matmul_mma(
                *ptrs, b, din, dout, x.stride(0), out.stride(0), kchunk, ks,
                chunks, stream)
        else:
            err = lib.dli_q4_matmul(
                *ptrs, None if part is None else part.data_ptr(),
                _DTYPE_CODE[x.dtype], b, din, dout, x.stride(0),
                out.stride(0), ks, chunks, stream)
    build.check(lib, err, f"{name} kernel launch")
    return out, mma


def q4_matmul(x, p4, scale):
    """x [b, din] @ unpack(p4 [din/2, dout] uint8) * scale [dout] f32 ->
    [b, dout] in x's dtype; b <= MAX_PALLAS_ROWS on the card."""
    if x.device.type == "cpu":
        return q4_matmul_ref(x, p4, scale)
    out, mma = _launch("q4_matmul", x, p4, scale, 1)
    launches.count(q4_matmul, mma)
    return out


q4_matmul.launches = 0
q4_matmul.launches_mma = 0


def q4_matmul_row(x, p4, scale, chunks: int = 1):
    """``q4_matmul`` over a chunk-local int4 pack of ``chunks`` chunks
    (ops/quant.py ``repack_int4_rows``): x [b, din] @ unpack_int4(p4,
    chunks) * scale -> [b, dout] in x's dtype. On a tp rank, p4 is the
    rank's one chunk and the caller sums the partials over the group."""
    if x.device.type == "cpu":
        return q4_matmul_row_ref(x, p4, scale, chunks)
    out, mma = _launch("q4_matmul_row", x, p4, scale, chunks)
    launches.count(q4_matmul_row, mma)
    return out


q4_matmul_row.launches = 0
q4_matmul_row.launches_mma = 0


def q4_linear(x, leaf, shards: int = 1):
    """An int4 linear over ``leaf`` {"p4", "scale"[, "chunked"]} with any
    leading dims on x (the JAX package's ``q4_linear``). A chunked leaf
    of which this rank holds one of ``shards`` equal din slices (the
    row-parallel o and down under tp) yields this rank's partial sum:
    the caller reduces it over the group."""
    p4, scale = leaf["p4"], leaf["scale"]
    din, dout = x.shape[-1], p4.shape[-1]
    lead = x.shape[:-1]
    rows = math.prod(lead)
    chunks = pack_chunks(leaf) // shards     # on this rank's slice
    if p4.dim() == 2 and supported(rows, din, dout):
        x2 = x.reshape(rows, din)
        y = (q4_matmul_row(x2, p4, scale, chunks) if "chunked" in leaf
             else q4_matmul(x2, p4, scale)).reshape(*lead, dout)
    else:
        y = torch.matmul(x, unpack_int4(p4, chunks).to(x.dtype)) \
            * scale.to(x.dtype)
    return y.to(x.dtype)
