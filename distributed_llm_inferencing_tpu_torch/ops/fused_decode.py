"""Fused q projection -> RoPE -> paged flash decode: CUDA kernel, plain
version, and the routing gate.

Counterpart of the JAX package's ``ops/pallas/fused_decode.py``. The
unfused decode step runs the q projection, RoPE and paged attention as
separate kernels, so q makes a round trip through device memory between
them; ``fused_decode_step`` chains the three in one launch
(``csrc/fused_decode.cu``), with q kept on chip in f32.

The kernel is one launch of thread-block clusters, one cluster of CS
blocks per (kv head, row group of up to ``FUSED_ROWS`` slots), in four
phases that share results through the cluster's distributed shared
memory:

- A, the q projection: block rank j multiplies its contiguous 1/CS slice
  of the weight's stored rows (whole ring stages, ``fused_stage_rows``)
  for every column of its kv head and every slot of the group, so a row
  group reads the weight once. bf16 x runs on the tensor cores, f32 x on
  the CUDA cores: the rule is ``fused_form``, by dtype alone.
- B: the CS partial sums added in rank order, then the scale (quantized
  forms), then RoPE, into every block's f32 copy of q.
- C: split-KV attention. The cluster's workers (CS x teams of 128
  threads) each take an equal span of the row group's live keys, cut
  into work items of at most ``FUSED_SPLIT`` keys of one (slot, head
  group), and merge their items per (slot, head) in order.
- D: the workers' partials merged by log-sum-exp in worker order.

``fused_decode_step_cluster_model`` is that decomposition in plain
PyTorch (f32), the way ``paged_flash_decode_split_ref`` models the
split-KV kernel; ``fused_decode_step_ref`` stays the plain version.

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
tensor it launches the kernel or raises. ``launches`` counts launches,
one per wrapper call. The wrapper never synchronises with the host and
allocates nothing but its output.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

import torch

from distributed_llm_inferencing_tpu_torch.ops import build, launches, rope
from distributed_llm_inferencing_tpu_torch.ops.flash_attention import (
    _DTYPE_CODE, _strides, _window)
from distributed_llm_inferencing_tpu_torch.ops.paged_attention import (
    check_paged_inputs, merge_partials, paged_flash_decode_ref)
from distributed_llm_inferencing_tpu_torch.ops.quant import (
    LEAF_KEYS, dequantize_weight, leaf_form, refuse_chunked, unpack_int4)

# the kernel's decomposition (csrc/fused_decode.cu kSplit, kRT,
# kSplitHeads, kItemCost): keys of one attention work item at most, slots
# of a row group at most, query heads of one work item at most, and the
# keys that stand for a work item's setup when the keys are shared out
FUSED_SPLIT = 1024
FUSED_ROWS = 8
_ITEM_HEADS = 4
_ITEM_COST = 128
_lib = None


def enabled() -> bool:
    """``DLI_FUSED_DECODE=1`` opts the serving decode step into the fused
    kernel (off by default, as in the JAX package)."""
    return os.environ.get("DLI_FUSED_DECODE", "0") not in ("0", "false", "")


def eligible(cfg, quantized_cache: bool, tp: int = 1) -> bool:
    """The one routing predicate of the serving decode step
    (models/transformer.py ``Transformer.paged_decode_step``). False
    under tp (``tp`` > 1), as the JAX gate's single-device clause
    (``jax.device_count() == 1``) is on any multi-device run: a tp rank's
    batched decode takes ``paged_flash_decode``."""
    return (tp == 1 and enabled() and not quantized_cache
            and supported(cfg))


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


def fused_form(dtype) -> str:
    """The kernel's q-projection form, by x's dtype alone (never by a
    failure): "mma" for bf16 (mma.sync on the tensor cores; bf16 x and
    bf16 weights or exact int8/int4 levels, products exact in f32), "fma"
    for f32 (f32 FMAs on the CUDA cores: TF32 or bf16 products would
    round the f32 cross-checks)."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def fused_stage_rows(dtype, form: str) -> int:
    """Stored weight rows of one of the kernel's ring stages
    (``stage_rows``): a cluster rank's slice of the contraction is whole
    stages. The tensor-core form takes 16 rows a stage in the float form,
    32 in int8 and 32 packed rows in int4; the CUDA-core form 8 rows in
    the float form and 32 in int8 and int4."""
    if fused_form(dtype) == "mma":
        return 16 if form == "float" else 32
    return 8 if form == "float" else 32


def _online_merge(state, m, l, acc):
    """Fold one range's (m, l, acc) into a running (m, l, acc) partial,
    natural base; an empty state (m = -inf, l = 0) takes the range."""
    if state is None:
        return m, l, acc
    mo, lo, ao = state
    mn = torch.maximum(mo, m)
    a, b = torch.exp(mo - mn), torch.exp(m - mn)
    return mn, lo * a + l * b, ao * a[..., None] + acc * b[..., None]


def fused_decode_step_cluster_model(x, q_leaf, k_pool, v_pool, block_tables,
                                    context_lens, *, rope_cos=None,
                                    rope_sin=None,
                                    sliding_window: Optional[int] = None,
                                    cluster: int = 16, teams: int = 2,
                                    rows_per_group: int = FUSED_ROWS,
                                    split: int = FUSED_SPLIT):
    """The kernel's decomposition of ``fused_decode_step`` in plain
    PyTorch (f32):

    - the weight's stored rows (D, or D/2 packed rows in int4) cut into
      ``cluster`` slices of whole ring stages (``fused_stage_rows``), each
      slice's partial q = x's rows @ its exact levels, the partials added
      in rank order; then the scale (quantized forms), then RoPE;
    - per row group of ``rows_per_group`` slots, the live keys [max(0,
      len - window), len) of every (slot, head group of 4 query heads),
      slot by slot, head group by head group, each led by ``_ITEM_COST``
      keys that stand for a work item's setup, as one sequence of K:
      worker w of W = cluster x teams takes the live keys in [K*w/W,
      K*(w+1)/W), cut where they cross a (slot, head group) and into even
      pieces of at most ``split`` keys (the work items); each worker's
      partial (m, l, acc) per (slot, head) folded from its items in
      order, then the workers' partials merged with ``merge_partials`` in
      worker order.

    Returns [R, H, hd] in x's dtype."""
    form = leaf_form(q_leaf)
    R, D = x.shape
    _, bs, Hkv, hd = k_pool.shape
    xf = x.float()
    if form == "int4":
        rows = D // 2
        lv = unpack_int4(q_leaf["p4"]).float()            # [D, H*hd]
        lo, hi = lv[:rows], lv[rows:]
    else:
        rows = D
        lo = (q_leaf["w"] if form == "float" else q_leaf["q"]).float()
    stage = fused_stage_rows(x.dtype, form)
    kchunk = -(-(-(-rows // cluster)) // stage) * stage
    q = torch.zeros(R, lo.shape[1], dtype=torch.float32, device=x.device)
    for j in range(cluster):
        a, b = j * kchunk, min(rows, (j + 1) * kchunk)
        if a >= b:
            continue
        part = xf[:, a:b] @ lo[a:b]
        if form == "int4":
            part = part + xf[:, rows + a:rows + b] @ hi[a:b]
        q = q + part
    if form != "float":
        q = q * q_leaf["scale"].float()
    H = q.shape[1] // hd
    q = q.reshape(R, H, hd)
    if rope_cos is not None:
        rot = torch.cat([-q[..., hd // 2:], q[..., :hd // 2]], dim=-1)
        q = q * rope_cos.float()[:, None] + rot * rope_sin.float()[:, None]

    G = H // Hkv
    n_hg = -(-G // _ITEM_HEADS)
    W = cluster * teams
    kf, vf = k_pool.float(), v_pool.float()
    bt = block_tables.long()
    lens = [int(n) for n in context_lens.tolist()]
    scale = 1.0 / math.sqrt(hd)
    out = torch.zeros(R, Hkv, G, hd, dtype=torch.float32, device=x.device)
    for r0 in range(0, R, rows_per_group):
        items = []                          # (worker, r, hg, s0, s1)
        segs = []                           # (r, hg, first key, keys)
        for r in range(r0, min(R, r0 + rows_per_group)):
            n = lens[r]
            beg = min(n, max(0, n - sliding_window) if sliding_window else 0)
            segs += [(r, hg, beg, n - beg) for hg in range(n_hg)]
        segs = [sg for sg in segs if sg[3] > 0]
        K = sum(sg[3] + _ITEM_COST for sg in segs)
        for w in range(W):
            lo, hi, o = K * w // W, K * (w + 1) // W, 0
            for r, hg, beg, c in segs:
                first = o + _ITEM_COST
                o = first + c
                a0, a1 = max(first, lo), min(o, hi)
                if a0 < a1:
                    s, nk = beg + a0 - first, a1 - a0
                    np_ = -(-nk // split)
                    items += [(w, r, hg, s + nk * p // np_,
                               s + nk * (p + 1) // np_) for p in range(np_)]
        state = {}                          # (worker, r, hg) -> partial
        for w, r, hg, s0, s1 in items:
            pos = torch.arange(s0, s1, device=x.device)
            blk = bt[r, pos // bs]
            kk, vv = kf[blk, pos % bs], vf[blk, pos % bs]   # [t, Hkv, hd]
            qh = q[r].reshape(Hkv, G, hd)[:, hg * _ITEM_HEADS:
                                          (hg + 1) * _ITEM_HEADS]
            sc = torch.einsum("hgd,thd->hgt", qh, kk) * scale
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            acc = torch.einsum("hgt,thd->hgd", p, vv)
            key = (w, r, hg)
            state[key] = _online_merge(state.get(key), m, p.sum(-1), acc)
        for r in range(r0, min(R, r0 + rows_per_group)):
            for hg in range(n_hg):
                h0, h1 = hg * _ITEM_HEADS, min(G, (hg + 1) * _ITEM_HEADS)
                parts = [state.get((w, r, hg)) for w in range(W)]
                if all(pt is None for pt in parts):
                    continue                # no key: the row stays 0
                empty = (torch.full((Hkv, h1 - h0), float("-inf")),
                         torch.zeros(Hkv, h1 - h0),
                         torch.zeros(Hkv, h1 - h0, hd))
                parts = [pt if pt is not None else empty for pt in parts]
                m = torch.stack([pt[0] for pt in parts], -1)
                l = torch.stack([pt[1] for pt in parts], -1)
                acc = torch.stack([pt[2] for pt in parts], -2)
                out[r, :, h0:h1] = merge_partials(m, l, acc)
    return out.reshape(R, H, hd).to(x.dtype)


def _kernels():
    global _lib
    if _lib is None:
        lib = build.load("fused_decode")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dli_fused_decode_fwd.argtypes = (
            [P] * 10 + [I] * 8 + [P, F, I, P])
        lib.dli_fused_decode_fwd.restype = I
        lib.dli_fused_decode_plan.argtypes = [I] * 7 + [P]
        lib.dli_fused_decode_plan.restype = I
        _lib = lib
    return _lib


def kernel_plan(dtype, form: str, D: int, H: int, Hkv: int, hd: int,
                table_width: int):
    """The launch plan the kernel takes for a shape on the current card
    (its cluster size, slots per row group, attention teams per block,
    shared memory, and how many such clusters the occupancy API says run
    at once), for block tables of ``table_width`` entries a row. Launches
    nothing; needs the card."""
    lib = _kernels()
    out = (ctypes.c_int * 5)()
    err = lib.dli_fused_decode_plan(_DTYPE_CODE[dtype], _FORMS[form][0], D,
                                    H, Hkv, hd, table_width, out)
    build.check(lib, err, "fused_decode_step plan")
    return dict(zip(("cluster", "rows_per_group", "teams", "smem_bytes",
                     "clusters_fit"), out))


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
    launches.count(fused_decode_step)
    return out


fused_decode_step.launches = 0
