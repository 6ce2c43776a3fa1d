"""Paged flash decode: CUDA kernel and its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/paged_attention.py``. The
kernel lives in ``csrc/paged_attention.cu`` (built by ops/build.py); this
module holds the wrapper, which checks what the kernel takes, and the
plain version, which computes the same function:

``paged_flash_decode(q, k_pool, v_pool, block_tables, context_lens)``:
one query token per serving slot, q [R,1,H,hd], against one layer's block
pool [NB,bs,Hkv,hd] through ``block_tables`` [R,MB] int32 and
``context_lens`` [R] int32 (fill after this token's write: the query sits
at ``context_lens - 1``). Optional static ``sliding_window`` and score
``softcap`` (ops/flash_attention.py); no ALiBi and no int8 pool, as on
the TPU. A row with no admissible key comes out 0.

The kernel is split-KV: a first pass attends each slot's keys in ranges
of ``PAGED_SPLIT`` keys and writes per-range partials (running max,
denominator, unnormalised output), a second merges them by log-sum-exp.
``merge_partials`` is that merge in plain PyTorch and
``paged_flash_decode_split_ref`` the whole split arithmetic, cut as the
kernel cuts it; ``paged_flash_decode_ref`` stays the plain version.

The wrapper runs the plain version only for a CPU tensor. For a CUDA
tensor it launches the kernel, or raises: there is no fallback. Its
``launches`` counts wrapper calls that launched (one split pass and its
merge each).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from distributed_llm_inferencing_tpu_torch.ops import build, launches
from distributed_llm_inferencing_tpu_torch.ops.flash_attention import (
    MAX_HEAD_DIM, _DTYPE_CODE, _softcap, _strides, _window,
    masked_attention)

# keys per split of the kernel's first pass: a multiple of its 64-key tile
PAGED_SPLIT = 256
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        lib = build.load("paged_attention")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dli_paged_decode_fwd.argtypes = (
            [P] * 7 + [I] * 8 + [P, F, I, F, P])
        lib.dli_paged_decode_fwd.restype = I
        _lib = lib
    return _lib


def check_paged_inputs(name, q, k_pool, v_pool, block_tables, context_lens,
                       H, hd):
    """Raise on what the paged kernels do not take: one CUDA device, f32
    or bf16 pools of q's dtype, pools [NB,bs,Hkv,hd] with a contiguous
    last dim and 16-byte aligned rows, block_tables [R,MB] int32 with
    contiguous rows, context_lens [R] int32 contiguous."""
    R = block_tables.shape[0] if block_tables.dim() == 2 else -1
    dev = q.device
    for t in (k_pool, v_pool, block_tables, context_lens):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every input must lie on {dev}")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"{name}: takes float32 or bfloat16 inputs of one "
                        f"dtype, got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape \
            or k_pool.shape[3] != hd or H % k_pool.shape[2]:
        raise ValueError(f"{name}: pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match H={H} hd={hd}")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {hd} must be a multiple of 8 in "
                         f"[8, {MAX_HEAD_DIM}]")
    for t in (k_pool, v_pool):
        if (t.stride(3) != 1 or any(t.stride(d) % 8 for d in range(3))
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: pools need a contiguous last dim and "
                             "16-byte aligned rows (strides % 8 == 0)")
    if (R < 1 or block_tables.dtype != torch.int32
            or block_tables.stride(1) != 1):
        raise ValueError(f"{name}: block_tables must be [R, MB] int32 with "
                         "contiguous rows")
    if (context_lens.shape != (R,) or context_lens.dtype != torch.int32
            or not context_lens.is_contiguous()):
        raise ValueError(f"{name}: context_lens must be [R] int32, "
                         "contiguous")


def paged_flash_decode_ref(q, k_pool, v_pool, block_tables, context_lens, *,
                           sliding_window: Optional[int] = None,
                           softcap: Optional[float] = None):
    """Plain version of ``paged_flash_decode``: gather each slot's blocks
    into a contiguous [R, MB*bs, Hkv, hd] view, then masked attention."""
    R, MB = block_tables.shape
    bs = k_pool.shape[1]
    bt = block_tables.long()
    k = k_pool[bt].reshape(R, MB * bs, *k_pool.shape[2:])
    v = v_pool[bt].reshape(R, MB * bs, *v_pool.shape[2:])
    lens = context_lens.to(torch.int64)
    kv_pos = torch.arange(MB * bs, device=q.device).expand(R, MB * bs)
    return masked_attention(q, k, v, (lens - 1)[:, None], kv_pos,
                            kv_pos < lens[:, None], sliding_window,
                            softcap=softcap)


def num_splits(max_blocks: int, block_size: int,
               split: int = PAGED_SPLIT) -> int:
    """Key ranges of the split pass: the table's width MB*bs over
    ``split``, so the host never reads ``context_lens``."""
    return max(1, -(-(max_blocks * block_size) // split))


def merge_partials(m, l, acc):
    """Log-sum-exp merge of split partials along the split axis: m and l
    [..., NS] (each range's running max and softmax denominator, any
    common base), acc [..., NS, hd] (its unnormalised output, in the
    base of m). A range with l == 0 counts for nothing (its m and acc are
    never read); a row whose l sums to 0 comes out 0. Returns [..., hd]."""
    live = l > 0
    top = torch.where(live, m, torch.full_like(m, float("-inf")))
    top = top.amax(-1, keepdim=True)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.where(live, torch.exp(m - top), torch.zeros_like(m))
    denom = (w * l).sum(-1, keepdim=True)
    num = (w[..., None] * torch.where(live[..., None], acc,
                                      torch.zeros_like(acc))).sum(-2)
    return torch.where(denom > 0,
                       num / torch.where(denom > 0, denom,
                                         torch.ones_like(denom)),
                       torch.zeros_like(num))


def paged_flash_decode_split_ref(q, k_pool, v_pool, block_tables,
                                 context_lens, *,
                                 sliding_window: Optional[int] = None,
                                 softcap: Optional[float] = None,
                                 split: int = PAGED_SPLIT):
    """The kernel's split arithmetic in plain PyTorch (f32): each slot's
    keys [max(0, len - window), len) cut into the ranges
    [s*split, (s+1)*split) for s < num_splits(MB, bs), a partial (m, l,
    acc) per range (empty ranges m = -inf, l = 0), then
    ``merge_partials``. Returns [R,1,H,hd] in q's dtype."""
    R, MB = block_tables.shape
    _, bs, Hkv, hd = k_pool.shape
    H = q.shape[2]
    ns = num_splits(MB, bs, split)
    n = ns * split
    bt = block_tables.long()
    k = k_pool[bt].reshape(R, MB * bs, Hkv, hd).float()
    v = v_pool[bt].reshape(R, MB * bs, Hkv, hd).float()
    pad = (0, 0, 0, 0, 0, n - MB * bs)
    k, v = (torch.nn.functional.pad(t, pad) for t in (k, v))
    lens = context_lens.to(torch.int64).to(q.device)
    pos = torch.arange(n, device=q.device)
    valid = pos[None, :] < lens[:, None]
    if sliding_window is not None:
        valid &= pos[None, :] >= (lens - sliding_window)[:, None]
    qf = q.float().reshape(R, Hkv, H // Hkv, hd)
    s = torch.einsum("rhgd,rthd->rhgt", qf, k) / math.sqrt(hd)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    s = s.reshape(R, Hkv, H // Hkv, ns, split)
    m = s.amax(-1)
    p = torch.exp(s - torch.where(torch.isfinite(m), m,
                                  torch.zeros_like(m))[..., None])
    acc = torch.einsum("rhgnt,rnthd->rhgnd", p,
                       v.reshape(R, ns, split, Hkv, hd))
    out = merge_partials(m, p.sum(-1), acc)
    return out.reshape(R, 1, H, hd).to(q.dtype)


def paged_flash_decode(q, k_pool, v_pool, block_tables, context_lens, *,
                       sliding_window: Optional[int] = None,
                       softcap: Optional[float] = None):
    """Paged single-token attention without a gather.

    q [R,1,H,hd]; k_pool/v_pool [NB,bs,Hkv,hd] (one layer's view of the
    pool, already holding this token's K/V); block_tables [R,MB] int32;
    context_lens [R] int32. The kernel reads the tables on the device: no
    host sync. Returns [R,1,H,hd] in q's dtype.
    """
    if q.device.type == "cpu":
        return paged_flash_decode_ref(q, k_pool, v_pool, block_tables,
                                      context_lens,
                                      sliding_window=sliding_window,
                                      softcap=softcap)
    R, one, H, hd = q.shape
    if one != 1:
        raise ValueError("paged_flash_decode takes exactly one query token")
    check_paged_inputs("paged_flash_decode", q, k_pool, v_pool,
                       block_tables, context_lens, H, hd)
    if (block_tables.shape[0] != R or q.stride(3) != 1
            or any(q.stride(d) % 8 for d in (0, 2)) or q.data_ptr() % 16):
        raise ValueError("paged_flash_decode: q must be [R,1,H,hd] with a "
                         "contiguous last dim and 16-byte aligned rows")
    window = _window(sliding_window)
    cap = _softcap(softcap)
    bs = k_pool.shape[1]
    ns = num_splits(block_tables.shape[1], bs)
    out = torch.empty((R, 1, H, hd), dtype=q.dtype, device=q.device)
    part = torch.empty(R * H * ns * (hd + 2), dtype=torch.float32,
                       device=q.device)
    lib = _kernels()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dli_paged_decode_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            out.data_ptr(), block_tables.data_ptr(), context_lens.data_ptr(),
            part.data_ptr(), _DTYPE_CODE[q.dtype], R, H, k_pool.shape[2], hd,
            bs, PAGED_SPLIT, ns,
            _strides((q, (0, 2)), (block_tables, (0,)),
                     (k_pool, (0, 1, 2)), (v_pool, (0, 1, 2)),
                     (out, (0, 2))),
            1.0 / math.sqrt(hd), window, cap, stream)
    build.check(lib, err, "paged_flash_decode kernel launch")
    launches.count(paged_flash_decode)
    return out


paged_flash_decode.launches = 0
