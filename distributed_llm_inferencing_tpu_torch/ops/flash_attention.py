"""Flash attention (prefill) and flash decode: CUDA kernels and their plain
PyTorch versions.

Counterpart of the JAX package's ``ops/pallas/flash_attention.py``. The
kernels live in ``csrc/flash_attention.cu`` (built by ops/build.py);
this module holds the wrappers, which check what the kernels take, and
the plain versions, which compute the same function:

- ``flash_attention(q, k, v)``: causal attention over the fresh block,
  q [B,S,H,hd], k/v [B,S,Hkv,hd], positions 0..S-1.
- ``flash_decode(q, k, v, lengths)``: one query token per row against the
  dense cache, q [B,1,H,hd], k/v [B,S,Hkv,hd], query at ``lengths-1``.
  The kernel is split-KV: a first pass attends each row's keys in ranges
  of ``decode_split(...)`` keys (from shapes alone) and writes per-range
  partials, a second merges them by log-sum-exp;
  ``flash_decode_split_ref`` is that arithmetic in plain PyTorch.

Both take an optional static ``sliding_window``, per-head ALiBi
``alibi`` slopes [H] and a score ``softcap`` (gemma2's
``cap * tanh(score / cap)`` on the scaled score, before ALiBi and the
masks); rows with no admissible key come out 0. Without a cap the
kernels take the branch they always took: the same bits as before the
cap arm existed.

A wrapper runs the plain version only for a CPU tensor. For a CUDA
tensor it launches the kernel, or raises: there is no fallback. Each
wrapper's ``launches`` counts its kernel launches, so a run can show
that its attention went through the kernels.

The prefill has two hand-written forms, picked by ``prefill_form`` from
dtype and head_dim alone: "mma" (bf16, head_dim a multiple of 16: the
tensor-core kernel, the serving path) and "simt" (f32, or another
head_dim: the CUDA-core kernel). ``flash_attention.launches_mma`` counts
the tensor-core launches among ``flash_attention.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from distributed_llm_inferencing_tpu_torch.ops import build, launches

MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# keys per split of the decode kernel's first pass (multiples of its
# 64-key tile): 128 as a rule, 64 where the grid would leave half the SMs
# idle, longer where a row would have more than DECODE_MAX_SPLITS partials
DECODE_SPLIT, DECODE_MAX_SPLIT, DECODE_MAX_SPLITS = 128, 1024, 64
_HEADS_PER_BLOCK = 4   # query heads one split block attends (kSplitHeads)
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dli_flash_attention_fwd.argtypes = (
            [P, P, P, P, P] + [I] * 6 + [P, F, I, F, P])
        lib.dli_flash_attention_fwd.restype = I
        lib.dli_flash_attention_mma_fwd.argtypes = (
            [P, P, P, P, P] + [I] * 5 + [P, F, I, F, P])
        lib.dli_flash_attention_mma_fwd.restype = I
        lib.dli_flash_decode_fwd.argtypes = (
            [P] * 7 + [I] * 7 + [P, F, I, F, P])
        lib.dli_flash_decode_fwd.restype = I
        _lib = lib
    return _lib


def _strides(*pairs):
    vals = [int(t.stride(d)) for t, dims in pairs for d in dims]
    return (ctypes.c_longlong * len(vals))(*vals)


def _check_inputs(name, q, k, v, alibi):
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % Hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} (GQA needs H % Hkv == 0)")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {hd} must be a multiple of 8 "
                         f"in [8, {MAX_HEAD_DIM}]")
    for t in (q, k, v):
        # 16-byte vector loads: last dim contiguous, rows 16-byte aligned
        if (t.stride(3) != 1 or any(t.stride(d) % 8 for d in range(3))
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: inputs need a contiguous last dim and "
                             "16-byte aligned rows (strides % 8 == 0)")
    if alibi is not None:
        if alibi.shape != (H,) or alibi.dtype != torch.float32 \
                or alibi.device != q.device or not alibi.is_contiguous():
            raise ValueError(f"{name}: alibi must be [H] float32, "
                             "contiguous, on q's device")


def _window(sliding_window) -> int:
    if sliding_window is None:
        return 0
    if int(sliding_window) < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    return int(sliding_window)


def _softcap(softcap) -> float:
    """The kernels' cap argument: 0 for none."""
    if softcap is None:
        return 0.0
    if not float(softcap) > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    return float(softcap)


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def masked_attention(q, k, v, q_pos, kv_pos, kv_valid,
                     sliding_window: Optional[int] = None, alibi=None,
                     scale: Optional[float] = None,
                     softcap: Optional[float] = None, sinks=None):
    """Causal attention in plain PyTorch, the kernels' function: f32
    scores, scale (default hd**-0.5), ``softcap * tanh(s / softcap)``,
    ALiBi slope*(kv - q), mask (kv <= q, slot valid, q - kv < window),
    softmax, and 0 for a row with no admissible key. q [B,Sq,H,hd]; k
    [B,Skv,Hkv,hd]; v [B,Skv,Hkv,vd] (vd may differ from hd: MLA's
    latent decode reads v as a slice of k); q_pos [B,Sq];
    kv_pos/kv_valid [B,Skv]. GQA groups by reshape (no repeat).
    ``sinks`` [H] (gpt-oss): one f32 logit per head joins every row's
    softmax as a column with no value row, as the reference's ``attend``
    adds and drops it; no kernel has that arm."""
    B, Sq, H, hd = q.shape
    Hkv, vd = k.shape[2], v.shape[-1]
    G = H // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    rel = kv_pos[:, None, :] - q_pos[:, :, None]                # [B,Sq,Skv]
    if alibi is not None:
        sl = alibi.float().to(q.device).reshape(1, Hkv, G, 1, 1)
        s = s + sl * rel.float()[:, None, None]
    mask = (rel <= 0) & kv_valid[:, None, :]
    if sliding_window is not None:
        mask = mask & (-rel < sliding_window)
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    if sinks is not None:
        sk = sinks.float().reshape(1, Hkv, G, 1, 1)
        m = torch.maximum(m, sk)
    m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if sinks is not None:   # the sink's share of the denominator
        l = l + torch.exp(sk - m)
    l = l.permute(0, 3, 1, 2, 4)                                # [B,Sq,Hkv,G,1]
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    out = torch.where(l > 0, o / torch.where(l > 0, l, torch.ones_like(l)),
                      torch.zeros_like(o))
    return out.reshape(B, Sq, H, vd).to(q.dtype)


# ----------------------------------------------------------------------
# Prefill
# ----------------------------------------------------------------------

def flash_attention_ref(q, k, v, *, sliding_window: Optional[int] = None,
                        alibi=None, softcap: Optional[float] = None):
    """Plain version of ``flash_attention``."""
    B, S = q.shape[:2]
    pos = torch.arange(S, device=q.device).expand(B, S)
    return masked_attention(q, k, v, pos, pos,
                            torch.ones(B, S, dtype=torch.bool,
                                       device=q.device),
                            sliding_window, alibi, softcap=softcap)


def prefill_form(dtype, head_dim: int) -> str:
    """Which prefill kernel takes these inputs: "mma" (tensor cores) for
    bf16 with head_dim % 16 == 0, "simt" (CUDA cores) otherwise."""
    return "mma" if dtype == torch.bfloat16 and head_dim % 16 == 0 \
        else "simt"


def flash_attention(q, k, v, *, sliding_window: Optional[int] = None,
                    alibi=None, softcap: Optional[float] = None):
    """Causal flash attention over the fresh block (prefill).

    q [B,S,H,hd]; k/v [B,S,Hkv,hd]; ``alibi`` [H] f32 slopes; ``softcap``
    a score cap or None. Returns
    [B,S,H,hd] in q's dtype. CUDA tensors launch the kernel; CPU tensors
    run ``flash_attention_ref``.
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, sliding_window=sliding_window,
                                   alibi=alibi, softcap=softcap)
    _check_inputs("flash_attention", q, k, v, alibi)
    cap = _softcap(softcap)
    B, S, H, hd = q.shape
    if k.shape[1] != S:
        raise ValueError("flash_attention: k/v must hold the same S as q")
    window = _window(sliding_window)
    mma = prefill_form(q.dtype, hd) == "mma"
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    strides = _strides((q, (0, 1, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                       (out, (0, 1, 2)))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _ptr(alibi))
    lib = _kernels()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if mma:
            err = lib.dli_flash_attention_mma_fwd(
                *ptrs, B, S, H, k.shape[2], hd, strides,
                1.0 / math.sqrt(hd), window, cap, stream)
        else:
            err = lib.dli_flash_attention_fwd(
                *ptrs, _DTYPE_CODE[q.dtype], B, S, H, k.shape[2], hd,
                strides, 1.0 / math.sqrt(hd), window, cap, stream)
    build.check(lib, err, "flash_attention kernel launch")
    launches.count(flash_attention, mma)
    return out


flash_attention.launches = 0
flash_attention.launches_mma = 0


# ----------------------------------------------------------------------
# Decode
# ----------------------------------------------------------------------

def flash_decode_ref(q, k, v, lengths, *,
                     sliding_window: Optional[int] = None, alibi=None,
                     softcap: Optional[float] = None):
    """Plain version of ``flash_decode``."""
    B, S = k.shape[:2]
    lengths = lengths.to(torch.int64)
    kv_pos = torch.arange(S, device=q.device).expand(B, S)
    return masked_attention(q, k, v, (lengths - 1)[:, None], kv_pos,
                            kv_pos < lengths[:, None], sliding_window, alibi,
                            softcap=softcap)


def decode_split(batch: int, num_heads: int, kv_heads: int, capacity: int,
                 sms: int) -> int:
    """Keys per split of the decode kernel, from shapes alone (the host
    never reads the lengths). 128 keys, two 64-key tiles so that one's
    copy overlaps the other's compute: on an H100 it was the fastest split
    from 1 to 8 blocks per SM (llama-3-8b at B=1 and 4, a tp=2 rank). 64
    where the grid (kv heads x head groups x batch x splits) would leave
    half the SMs idle; doubled while a row would have more than
    ``DECODE_MAX_SPLITS`` partials for the merge to read."""
    groups = kv_heads * -(-(num_heads // kv_heads) // _HEADS_PER_BLOCK)
    split = DECODE_SPLIT
    if batch * groups * -(-capacity // split) < sms // 2:
        split //= 2
    while -(-capacity // split) > DECODE_MAX_SPLITS \
            and split < DECODE_MAX_SPLIT:
        split *= 2
    return split


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_decode_split_ref(q, k, v, lengths, *,
                           sliding_window: Optional[int] = None, alibi=None,
                           softcap: Optional[float] = None, split: int = 64):
    """The decode kernel's split arithmetic in plain PyTorch (f32): each
    row's keys [max(0, len - window), len) cut into the ranges
    [s*split, (s+1)*split) for s < ceil(S / split), a partial (m, l, acc)
    per range (empty ranges m = -inf, l = 0), then ops/paged_attention.py
    ``merge_partials``. Returns [B,1,H,hd] in q's dtype."""
    from distributed_llm_inferencing_tpu_torch.ops.paged_attention import (
        merge_partials)
    B, S, Hkv, hd = k.shape
    H = q.shape[2]
    G = H // Hkv
    ns = -(-S // split)
    n = ns * split
    pad = (0, 0, 0, 0, 0, n - S)
    kf, vf = (torch.nn.functional.pad(t.float(), pad) for t in (k, v))
    lens = lengths.to(torch.int64).to(q.device)
    pos = torch.arange(n, device=q.device)
    valid = pos[None, :] < lens[:, None]
    if sliding_window is not None:
        valid &= pos[None, :] >= (lens - sliding_window)[:, None]
    qf = q.float().reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bthd->bhgt", qf, kf) / math.sqrt(hd)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    if alibi is not None:
        rel = (pos[None, :] - (lens - 1)[:, None]).float()       # [B, n]
        s = s + alibi.float().to(q.device).reshape(1, Hkv, G, 1) \
            * rel[:, None, None]
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    s = s.reshape(B, Hkv, G, ns, split)
    m = s.amax(-1)
    p = torch.exp(s - torch.where(torch.isfinite(m), m,
                                  torch.zeros_like(m))[..., None])
    acc = torch.einsum("bhgnt,bnthd->bhgnd", p,
                       vf.reshape(B, ns, split, Hkv, hd))
    out = merge_partials(m, p.sum(-1), acc)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def flash_decode(q, k, v, lengths, *, sliding_window: Optional[int] = None,
                 alibi=None, softcap: Optional[float] = None):
    """Cached single-token attention (the decode hot loop).

    q [B,1,H,hd]; k/v [B,S,Hkv,hd] (the cache, already holding the new
    token); lengths [B] int32 = filled slots after this token's write. The
    query sits at ``lengths-1``; valid slots are ``[0, lengths)``. The
    kernel reads ``lengths`` on the device: no host sync. Returns
    [B,1,H,hd] in q's dtype.
    """
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, lengths,
                                sliding_window=sliding_window, alibi=alibi,
                                softcap=softcap)
    _check_inputs("flash_decode", q, k, v, alibi)
    cap = _softcap(softcap)
    B, one, H, hd = q.shape
    if one != 1:
        raise ValueError("flash_decode takes exactly one query token")
    if (lengths.shape != (B,) or lengths.dtype != torch.int32
            or lengths.device != q.device or not lengths.is_contiguous()):
        raise ValueError("flash_decode: lengths must be [B] int32, "
                         "contiguous, on q's device")
    window = _window(sliding_window)
    S, Hkv = k.shape[1], k.shape[2]
    split = decode_split(B, H, Hkv, S, _sm_count(q.device.index))
    ns = -(-S // split)
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    part = torch.empty(B * H * ns * (hd + 2), dtype=torch.float32,
                       device=q.device)
    lib = _kernels()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dli_flash_decode_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lengths.data_ptr(), _ptr(alibi), part.data_ptr(),
            _DTYPE_CODE[q.dtype], B, H, Hkv, hd, split, ns,
            _strides((q, (0, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                     (out, (0, 2))),
            1.0 / math.sqrt(hd), window, cap, stream)
    build.check(lib, err, "flash_decode kernel launch")
    launches.count(flash_decode)
    return out


flash_decode.launches = 0
