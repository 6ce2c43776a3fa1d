"""The CUDA kernels against their plain versions, on the card:
flash_attention (both forms: the bf16 tensor-core kernel and the CUDA-core
one), flash_decode and paged_flash_decode (both split-KV),
fused_decode_step (float, int8 and int4 weight forms, bf16 and f32, over
the cluster kernel's edges: row groups, item edges, windows, MHA/GQA/MQA,
hd 16-256), q4_matmul and q4_matmul_row (both forms: bf16 on the tensor
cores, f32 on the CUDA cores); the dense families' head shapes (ALiBi
heads, a group of 71, hd 80 and 256) through the attention kernels; the
softcap arms of flash_attention, flash_decode and paged_flash_decode
(gemma-2's heads and cap, caps that bite, GQA/MQA, windows, ALiBi), and
the uncapped arms' bits against digests taken before the cap arm
existed; the decodes at a tp rank's shapes over a replicated kv head.
The tensor-core kernels, the split-KV decodes, the softcap arms
and the fused kernel are also held to the same bits across two
launches.

Marked ``cuda``: each test skips where no CUDA device is visible (the
decision is made inside the test, never at import). On a GPU machine run
``python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda``.
Tolerances: f32 2e-5 (summation order only); bf16 rtol = atol = 1e-2
(both sides round one f32 result to bf16, one ulp is 2^-7 relative); the
paged and fused decodes in bf16 rtol 2^-7, atol 1e-4 (at most one ulp
apart, plus the f32 summation-order error). q4_matmul: the f32
summation-order bound 2 * din * 2^-24 * (|x| @ |levels|) * scale, plus one
bf16 ulp (2^-7 |ref|) in bf16; q4_matmul_row the same bound over its
chunk-local unpack.
"""

import numpy as np
import pytest
import torch

from distributed_llm_inferencing_tpu_torch.ops import flash_attention as fa
from distributed_llm_inferencing_tpu_torch.ops import fused_decode as fd
from distributed_llm_inferencing_tpu_torch.ops import paged_attention as pa
from distributed_llm_inferencing_tpu_torch.ops import quant as tq
from distributed_llm_inferencing_tpu_torch.ops import quant_matmul as qm
from distributed_llm_inferencing_tpu_torch.ops.attention import alibi_slopes


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _tol(dtype):
    return (dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32
            else dict(rtol=1e-2, atol=1e-2))


def _paged_tol(dtype):
    return (dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32
            else dict(rtol=2 ** -7, atol=1e-4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Hkv,hd,window,alibi", [
    (2, 64, 8, 4, 64, None, False),
    (1, 48, 2, 2, 16, None, False),
    (2, 128, 8, 1, 128, None, False),
    (2, 100, 4, 2, 32, 16, False),
    (2, 64, 4, 4, 256, None, True),
    (1, 512, 32, 8, 128, None, False),
])
def test_flash_attention_kernel_matches_ref(dtype, B, S, H, Hkv, hd, window,
                                            alibi):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    q = _rand(g, (B, S, H, hd), dtype, dev)
    k, v = (_rand(g, (B, S, Hkv, hd), dtype, dev) for _ in range(2))
    sl = alibi_slopes(H, dev) if alibi else None
    n0 = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, sliding_window=window, alibi=sl)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    ref = fa.flash_attention_ref(q, k, v, sliding_window=window, alibi=sl)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths,H,Hkv,hd,window,alibi", [
    ([37, 90], 8, 4, 64, None, False),
    ([1, 128], 8, 1, 128, None, False),
    ([0, 64], 4, 4, 32, None, False),
    ([50, 20], 4, 2, 32, 8, False),
    ([37, 101], 8, 2, 256, None, True),
    ([1, 37, 1000, 4096], 32, 8, 128, None, False),
])
def test_flash_decode_kernel_matches_ref(dtype, lengths, H, Hkv, hd, window,
                                         alibi):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    B, S = len(lengths), max(128, max(lengths))
    q = _rand(g, (B, 1, H, hd), dtype, dev)
    k, v = (_rand(g, (B, S, Hkv, hd), dtype, dev) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    sl = alibi_slopes(H, dev) if alibi else None
    out = fa.flash_decode(q, k, v, lens, sliding_window=window, alibi=sl)
    torch.cuda.synchronize()
    ref = fa.flash_decode_ref(q, k, v, lens, sliding_window=window, alibi=sl)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths,S,H,Hkv,hd,window,alibi", [
    ("edges", 4096, 32, 8, 128, None, False),   # llama-3-8b heads
    ([4096], 4096, 32, 8, 128, None, False),     # the engine: B=1, full
    ([4096, 532], 4096, 16, 4, 128, None, False),   # a tp=2 rank's heads
    ([0, 300], 512, 8, 8, 64, None, False),      # MHA, a length-0 row
    ([1000, 3], 1024, 8, 1, 256, None, False),   # MQA, hd 256
    ("edges", 1024, 8, 2, 64, 100, False),       # window under a split
    ([900, 700], 1024, 8, 2, 128, 400, True),    # window across splits
    ([37, 200], 256, 12, 4, 128, None, True),    # G=3, ALiBi
])
def test_flash_decode_split_edges(dtype, lengths, S, H, Hkv, hd, window,
                                  alibi):
    """The split-KV decode at its own split's edges (split - 1, split,
    split + 1, 2 * split + 1, and 0 keys), at B=1 over a full cache, MHA,
    GQA and MQA, hd 64-256, windows and ALiBi; the same bits on a second
    launch."""
    dev = _cuda()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if lengths == "edges":
        sp = fa.decode_split(5, H, Hkv, S, sms)
        lengths = [min(S, n) for n in (sp - 1, sp, sp + 1, 2 * sp + 1, 0)]
    g = torch.Generator(device=dev).manual_seed(sum(lengths) + hd)
    B = len(lengths)
    q = _rand(g, (B, 1, H, hd), dtype, dev)
    k, v = (_rand(g, (B, S, Hkv, hd), dtype, dev) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    sl = alibi_slopes(H, dev) if alibi else None
    n0 = fa.flash_decode.launches
    out = fa.flash_decode(q, k, v, lens, sliding_window=window, alibi=sl)
    torch.cuda.synchronize()
    assert fa.flash_decode.launches == n0 + 1
    ref = fa.flash_decode_ref(q, k, v, lens, sliding_window=window, alibi=sl)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))
    for i, n in enumerate(lengths):
        assert bool((out[i] == 0).all()) == (n == 0)
    again = fa.flash_decode(q, k, v, lens, sliding_window=window, alibi=sl)
    assert torch.equal(out, again)     # fixed merge order: same bits


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,hd,window,alibi", [
    (1, 1, 4, 2, 128, None, False),        # one row
    (1, 17, 8, 2, 128, None, False),       # under one tile
    (2, 100, 8, 8, 64, None, False),       # MHA, B=2, ragged last tile
    (1, 513, 8, 1, 128, None, False),      # MQA, one row past a tile
    (1, 200, 4, 2, 256, None, False),      # hd 256 (32-key tiles)
    (2, 130, 4, 4, 16, None, False),       # hd 16
    (2, 300, 8, 2, 128, 70, False),        # a window across tile edges
    (1, 150, 4, 2, 64, 33, True),          # window and ALiBi
    (1, 257, 8, 4, 80, None, True),        # hd 80, ALiBi
])
def test_flash_attention_mma_form_edges(B, S, H, Hkv, hd, window, alibi):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(S + hd)
    dtype = torch.bfloat16
    q = _rand(g, (B, S, H, hd), dtype, dev)
    k, v = (_rand(g, (B, S, Hkv, hd), dtype, dev) for _ in range(2))
    sl = alibi_slopes(H, dev) if alibi else None
    assert fa.prefill_form(dtype, hd) == "mma"
    n0, m0 = fa.flash_attention.launches, fa.flash_attention.launches_mma
    out = fa.flash_attention(q, k, v, sliding_window=window, alibi=sl)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    assert fa.flash_attention.launches_mma == m0 + 1
    ref = fa.flash_attention_ref(q, k, v, sliding_window=window, alibi=sl)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))
    again = fa.flash_attention(q, k, v, sliding_window=window, alibi=sl)
    assert torch.equal(out, again)     # fixed reduction order: same bits


@pytest.mark.cuda
def test_flash_attention_f32_keeps_the_cuda_core_form():
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(9)
    q = _rand(g, (1, 70, 4, 64), torch.float32, dev)
    k = _rand(g, (1, 70, 2, 64), torch.float32, dev)
    n0, m0 = fa.flash_attention.launches, fa.flash_attention.launches_mma
    out = fa.flash_attention(q, k, k)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches,
            fa.flash_attention.launches_mma) == (n0 + 1, m0)
    torch.testing.assert_close(out, fa.flash_attention_ref(q, k, k),
                               **_tol(torch.float32))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _cuda()
    q = torch.zeros(1, 8, 2, 12, device=dev)          # hd not % 8
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 16, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 16, 2, device=dev).transpose(2, 3)  # hd strided
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)


def _paged_case(g, dev, dtype, lengths, H, Hkv, hd, bs, nb=None, mb=None):
    """A pool of random blocks and per-slot tables that are random
    permutations of its blocks (block 0 stays the dummy); ``mb`` table
    entries per slot (default: enough for the longest length)."""
    R = len(lengths)
    mb = mb or max(1, -(-max(lengths) // bs))
    nb = nb or R * mb + 1
    k_pool, v_pool = (_rand(g, (nb, bs, Hkv, hd), dtype, dev)
                      for _ in range(2))
    perm = torch.randperm(nb - 1, generator=g, device=dev) + 1
    bt = perm[:R * mb].reshape(R, mb).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return k_pool, v_pool, bt, lens


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths,H,Hkv,hd,bs,window", [
    ([5, 17, 32, 1], 4, 2, 16, 8, None),          # GQA, mid-block tails
    ([0, 16, 15, 17], 8, 8, 64, 16, None),        # MHA, zero + boundaries
    ([100, 3], 8, 1, 128, 16, None),               # MQA
    ([20, 13], 4, 4, 16, 8, 6),                    # window
    ([300, 65], 8, 2, 256, 16, 64),                # hd 256 + window
    ([0, 1, 15, 16, 17, 300, 1000, 4096], 32, 8, 128, 16, None),
])
def test_paged_flash_decode_kernel_matches_ref(dtype, lengths, H, Hkv, hd,
                                               bs, window):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(2)
    k_pool, v_pool, bt, lens = _paged_case(g, dev, dtype, lengths, H, Hkv,
                                           hd, bs)
    q = _rand(g, (len(lengths), 1, H, hd), dtype, dev)
    n0 = pa.paged_flash_decode.launches
    out = pa.paged_flash_decode(q, k_pool, v_pool, bt, lens,
                                sliding_window=window)
    torch.cuda.synchronize()
    assert pa.paged_flash_decode.launches == n0 + 1
    ref = pa.paged_flash_decode_ref(q, k_pool, v_pool, bt, lens,
                                    sliding_window=window)
    torch.testing.assert_close(out.float(), ref.float(), **_paged_tol(dtype))
    if lengths[0] == 0:
        assert (out[0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,hd", [
    (4, 256),      # gemma-2b at tp=2: 4 q heads over its one kv head
    (4, 128),      # llama-3-8b at tp=8: each rank's 4 q heads, 1 kv head
    (2, 128),      # llama-3-8b at tp=16
])
def test_tp_rank_shapes_over_a_replicated_kv_head(dtype, H, hd):
    """paged_flash_decode and flash_decode at a tp rank's shapes where
    the kv heads replicate (tp > Hkv, parallel/sharding.py ``kv_map``):
    the rank's H q heads over its one kv head (Hkv_local = 1), held to
    the plain versions (PAGED_BF16_TOL / TOL)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(H * hd)
    lengths = [0, 1, 17, 300, 1000, 4096]
    k_pool, v_pool, bt, lens = _paged_case(g, dev, dtype, lengths, H, 1,
                                           hd, 16)
    q = _rand(g, (len(lengths), 1, H, hd), dtype, dev)
    out = pa.paged_flash_decode(q, k_pool, v_pool, bt, lens)
    torch.cuda.synchronize()
    ref = pa.paged_flash_decode_ref(q, k_pool, v_pool, bt, lens)
    torch.testing.assert_close(out.float(), ref.float(), **_paged_tol(dtype))
    dense = [4096, 532]
    q = _rand(g, (len(dense), 1, H, hd), dtype, dev)
    k, v = (_rand(g, (len(dense), 4096, 1, hd), dtype, dev)
            for _ in range(2))
    dl = torch.tensor(dense, dtype=torch.int32, device=dev)
    out = fa.flash_decode(q, k, v, dl)
    torch.cuda.synchronize()
    ref = fa.flash_decode_ref(q, k, v, dl)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


_SPLIT = pa.PAGED_SPLIT


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths,mb,window", [
    ([_SPLIT - 1, _SPLIT, _SPLIT + 1, 2 * _SPLIT + 1], None, None),
    ([0, 1, 300], 256, None),        # MB*bs = 4096, far beyond every length
    ([600, 300, 5], None, 100),      # a window shorter than a split
    ([1000, 700], None, 400),        # a window spanning splits
])
def test_paged_flash_decode_split_edges(dtype, lengths, mb, window):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(sum(lengths))
    H, Hkv, hd, bs = 32, 8, 128, 16
    k_pool, v_pool, bt, lens = _paged_case(g, dev, dtype, lengths, H, Hkv,
                                           hd, bs, mb=mb)
    q = _rand(g, (len(lengths), 1, H, hd), dtype, dev)
    n0 = pa.paged_flash_decode.launches
    out = pa.paged_flash_decode(q, k_pool, v_pool, bt, lens,
                                sliding_window=window)
    torch.cuda.synchronize()
    assert pa.paged_flash_decode.launches == n0 + 1
    ref = pa.paged_flash_decode_ref(q, k_pool, v_pool, bt, lens,
                                    sliding_window=window)
    torch.testing.assert_close(out.float(), ref.float(), **_paged_tol(dtype))
    for i, n in enumerate(lengths):
        assert bool((out[i] == 0).all()) == (n == 0)
    again = pa.paged_flash_decode(q, k_pool, v_pool, bt, lens,
                                  sliding_window=window)
    assert torch.equal(out, again)     # fixed merge order: same bits


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths,H,Hkv,hd,D,bs,rope,window", [
    ([7, 21, 12], 4, 2, 16, 32, 8, True, None),    # GQA
    ([7, 21, 12], 4, 1, 16, 32, 8, True, None),    # MQA
    ([7, 21, 12], 4, 4, 16, 32, 8, True, None),    # MHA
    ([19, 8], 4, 2, 16, 32, 8, False, 5),          # no RoPE + window
    ([0, 16, 17, 33], 8, 2, 64, 256, 16, True, None),
    ([1, 15, 16, 17, 300, 1000, 4096, 0], 32, 8, 128, 4096, 16, True,
     None),                                        # llama-3-8b width
])
def test_fused_decode_kernel_matches_ref(dtype, lengths, H, Hkv, hd, D, bs,
                                         rope, window):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    k_pool, v_pool, bt, lens = _paged_case(g, dev, dtype, lengths, H, Hkv,
                                           hd, bs)
    R = len(lengths)
    x = _rand(g, (R, D), dtype, dev)
    w = (torch.randn(D, H * hd, generator=g, device=dev)
         / D ** 0.5).to(dtype)
    cos = sin = None
    if rope:
        ang = torch.rand(R, hd // 2, generator=g, device=dev) * 6.0
        cos = torch.cat([ang.cos(), ang.cos()], -1).contiguous()
        sin = torch.cat([ang.sin(), ang.sin()], -1).contiguous()
    n0 = fd.fused_decode_step.launches
    out = fd.fused_decode_step(x, {"w": w}, k_pool, v_pool, bt, lens,
                               rope_cos=cos, rope_sin=sin,
                               sliding_window=window)
    torch.cuda.synchronize()
    assert fd.fused_decode_step.launches == n0 + 1
    ref = fd.fused_decode_step_ref(x, {"w": w}, k_pool, v_pool, bt, lens,
                                   rope_cos=cos, rope_sin=sin,
                                   sliding_window=window)
    # f32: the GEMV sums D products in another order than the host's
    # matmul; bf16: one output rounding on each side
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
           else _paged_tol(dtype))
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.cuda
def test_paged_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(4)
    k_pool, v_pool, bt, lens = _paged_case(g, dev, torch.float32, [9, 3], 4,
                                           2, 16, 8)
    q = torch.zeros(2, 1, 4, 16, device=dev)
    with pytest.raises(ValueError):     # int64 tables
        pa.paged_flash_decode(q, k_pool, v_pool, bt.long(), lens)
    with pytest.raises(TypeError):      # dtype mix
        pa.paged_flash_decode(q.bfloat16(), k_pool, v_pool, bt, lens)
    x = torch.zeros(2, 32, device=dev)
    with pytest.raises(NotImplementedError):      # chunk-local int4 (A12)
        fd.fused_decode_step(x, {"p4": None, "scale": None, "chunked": None},
                             k_pool, v_pool, bt, lens)
    q8 = torch.zeros(32, 64, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):               # f64 scale
        fd.fused_decode_step(x, {"q": q8, "scale": torch.ones(
            64, dtype=torch.float64, device=dev)}, k_pool, v_pool, bt, lens)
    p4 = torch.zeros(16, 64, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):               # rows 33 > 32
        qm.q4_matmul(torch.zeros(33, 32, device=dev), p4,
                     torch.ones(64, device=dev))
    with pytest.raises(TypeError):                # int8 weight as p4
        qm.q4_matmul(torch.zeros(2, 32, device=dev), p4.to(torch.int8),
                     torch.ones(64, device=dev))


def _fused_quant_case(g, dev, form, D, H, hd):
    w = torch.randn(D, H * hd, generator=g, device=dev) / D ** 0.5
    return (tq.quantize_weight if form == "int8"
            else tq.quantize_weight_int4)(w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["int8", "int4"])
@pytest.mark.parametrize("lengths,H,Hkv,hd,D,bs,rope,window", [
    ([7, 21, 12], 4, 2, 16, 32, 8, True, None),    # GQA
    ([7, 21, 12], 4, 1, 16, 32, 8, True, None),    # MQA
    ([19, 8], 4, 4, 16, 32, 8, False, 5),          # MHA, no RoPE, window
    ([1, 15, 16, 17, 300, 1000, 4096, 0], 32, 8, 128, 4096, 16, True,
     None),                                        # llama-3-8b width
])
def test_fused_decode_quantized_forms_match_ref(dtype, form, lengths, H, Hkv,
                                                hd, D, bs, rope, window):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    k_pool, v_pool, bt, lens = _paged_case(g, dev, dtype, lengths, H, Hkv,
                                           hd, bs)
    R = len(lengths)
    x = _rand(g, (R, D), dtype, dev)
    leaf = _fused_quant_case(g, dev, form, D, H, hd)
    cos = sin = None
    if rope:
        ang = torch.rand(R, hd // 2, generator=g, device=dev) * 6.0
        cos = torch.cat([ang.cos(), ang.cos()], -1).contiguous()
        sin = torch.cat([ang.sin(), ang.sin()], -1).contiguous()
    kw = dict(rope_cos=cos, rope_sin=sin, sliding_window=window)
    n0 = fd.fused_decode_step.launches
    out = fd.fused_decode_step(x, leaf, k_pool, v_pool, bt, lens, **kw)
    torch.cuda.synchronize()
    assert fd.fused_decode_step.launches == n0 + 1
    ref = fd.fused_decode_step_ref(x, leaf, k_pool, v_pool, bt, lens, **kw)
    # the float form's bars: the kernel scales the f32 sum of x * levels,
    # the plain version sums x * (levels * scale)
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
           else _paged_tol(dtype))
    torch.testing.assert_close(out.float(), ref.float(), **tol)


# the cluster kernel's edges: one and several row groups of 8 slots (R 1,
# 3, 8, 9, 17), lengths at its 256-key item edges and 0, every slot at
# 4096, windows inside and across items, MHA/GQA/MQA (G = 8: two head
# groups), hd 16-256, D not a multiple of 16 ranks x 16 rows
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["float", "int8", "int4"])
@pytest.mark.parametrize("lengths,H,Hkv,hd,D,bs,rope,window", [
    ([300], 8, 2, 64, 256, 16, True, None),                 # R=1
    ([0, 255, 257], 32, 8, 128, 512, 16, True, None),       # R=3
    ([255, 256, 257, 511, 512, 513, 0, 1], 8, 2, 64, 128, 16, True,
     None),                                                 # R=8
    ([4096] * 9, 8, 2, 64, 128, 16, True, None),            # R=9, full
    ([(37 * i) % 700 for i in range(17)], 4, 1, 16, 40, 8, True,
     100),                                                  # R=17, MQA
    ([300, 65, 0], 4, 4, 256, 64, 16, False, 64),           # MHA, hd 256
    ([1000, 700], 32, 8, 128, 4096, 16, True, 400),         # across items
    ([600, 5], 8, 2, 128, 256, 16, True, 100),              # inside one
    ([100, 3, 0], 8, 1, 128, 512, 16, True, None),          # G = 8
    ([4096] * 8, 32, 8, 128, 4096, 16, True, None),         # full, llama
])
def test_fused_cluster_edges(dtype, form, lengths, H, Hkv, hd, D, bs, rope,
                             window):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(6)
    k_pool, v_pool, bt, lens = _paged_case(g, dev, dtype, lengths, H, Hkv,
                                           hd, bs)
    R = len(lengths)
    x = _rand(g, (R, D), dtype, dev)
    leaf = ({"w": (torch.randn(D, H * hd, generator=g, device=dev)
                   / D ** 0.5).to(dtype)} if form == "float"
            else _fused_quant_case(g, dev, form, D, H, hd))
    cos = sin = None
    if rope:
        ang = torch.rand(R, hd // 2, generator=g, device=dev) * 6.0
        cos = torch.cat([ang.cos(), ang.cos()], -1).contiguous()
        sin = torch.cat([ang.sin(), ang.sin()], -1).contiguous()
    kw = dict(rope_cos=cos, rope_sin=sin, sliding_window=window)
    n0 = fd.fused_decode_step.launches
    out = fd.fused_decode_step(x, leaf, k_pool, v_pool, bt, lens, **kw)
    torch.cuda.synchronize()
    assert fd.fused_decode_step.launches == n0 + 1
    ref = fd.fused_decode_step_ref(x, leaf, k_pool, v_pool, bt, lens, **kw)
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
           else _paged_tol(dtype))
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    for i, n in enumerate(lengths):
        assert bool((out[i] == 0).all()) == (n == 0)
    again = fd.fused_decode_step(x, leaf, k_pool, v_pool, bt, lens, **kw)
    assert torch.equal(out, again)     # fixed summation orders: same bits
    assert fd.fused_decode_step.launches == n0 + 2


# the dense families' shapes (models/registry.py) through the attention
# kernels: bloom-7b1's and falcon-rw-1b's ALiBi heads (falcon-rw's slopes
# scaled by hd**-0.5), falcon-7b's one kv head for 71 query heads, phi-2's
# hd 80 and gemma's hd 256 (gemma-7b MHA, gemma-2b MQA)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,hd,alibi_scale", [
    (32, 32, 128, 1.0),             # bloom-7b1
    (32, 32, 64, 64 ** -0.5),       # falcon-rw-1b
    (71, 1, 64, None),              # falcon-7b: a group of 71
])
def test_family_prefill_and_decode(dtype, H, Hkv, hd, alibi_scale):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(H + hd)
    sl = (None if alibi_scale is None
          else alibi_slopes(H, dev) * alibi_scale)
    q = _rand(g, (2, 300, H, hd), dtype, dev)
    k, v = (_rand(g, (2, 300, Hkv, hd), dtype, dev) for _ in range(2))
    n0, m0 = fa.flash_attention.launches, fa.flash_attention.launches_mma
    out = fa.flash_attention(q, k, v, alibi=sl)
    torch.cuda.synchronize()
    mma = int(dtype == torch.bfloat16)
    assert (fa.flash_attention.launches,
            fa.flash_attention.launches_mma) == (n0 + 1, m0 + mma)
    torch.testing.assert_close(
        out.float(), fa.flash_attention_ref(q, k, v, alibi=sl).float(),
        **_tol(dtype))
    assert torch.equal(out, fa.flash_attention(q, k, v, alibi=sl))
    lengths = [1, 300, 2047]
    q = _rand(g, (3, 1, H, hd), dtype, dev)
    k, v = (_rand(g, (3, 2048, Hkv, hd), dtype, dev) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out = fa.flash_decode(q, k, v, lens, alibi=sl)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out.float(), fa.flash_decode_ref(q, k, v, lens, alibi=sl).float(),
        **_tol(dtype))
    assert torch.equal(out, fa.flash_decode(q, k, v, lens, alibi=sl))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,hd,D", [
    (71, 1, 64, 4544),              # falcon-7b
    (32, 32, 80, 2560),             # phi-2
    (16, 16, 256, 3072),            # gemma-7b
    (8, 1, 256, 2048),              # gemma-2b
])
def test_family_paged_and_fused_decode(dtype, H, Hkv, hd, D):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(D)
    lengths = [0, 1, 17, 300, 1000, 2048, 5, 64]
    k_pool, v_pool, bt, lens = _paged_case(g, dev, dtype, lengths, H, Hkv,
                                           hd, 16)
    R = len(lengths)
    q = _rand(g, (R, 1, H, hd), dtype, dev)
    n0 = pa.paged_flash_decode.launches
    out = pa.paged_flash_decode(q, k_pool, v_pool, bt, lens)
    torch.cuda.synchronize()
    assert pa.paged_flash_decode.launches == n0 + 1
    torch.testing.assert_close(
        out.float(),
        pa.paged_flash_decode_ref(q, k_pool, v_pool, bt, lens).float(),
        **_paged_tol(dtype))
    assert torch.equal(out, pa.paged_flash_decode(q, k_pool, v_pool, bt,
                                                  lens))
    x = _rand(g, (R, D), dtype, dev)
    leaf = {"w": (torch.randn(D, H * hd, generator=g, device=dev)
                  / D ** 0.5).to(dtype)}
    ang = torch.rand(R, hd // 2, generator=g, device=dev) * 6.0
    kw = dict(rope_cos=torch.cat([ang.cos(), ang.cos()], -1).contiguous(),
              rope_sin=torch.cat([ang.sin(), ang.sin()], -1).contiguous())
    n0 = fd.fused_decode_step.launches
    out = fd.fused_decode_step(x, leaf, k_pool, v_pool, bt, lens, **kw)
    torch.cuda.synchronize()
    assert fd.fused_decode_step.launches == n0 + 1
    ref = fd.fused_decode_step_ref(x, leaf, k_pool, v_pool, bt, lens, **kw)
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
           else _paged_tol(dtype))
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    assert torch.equal(out, fd.fused_decode_step(x, leaf, k_pool, v_pool, bt,
                                                 lens, **kw))


def q4_bound(x, p4, scale, chunks=1):
    """|kernel - plain| allowed for q4_matmul: both sum din f32 products in
    some order, each within din * 2^-24 * sum|x * w| of the exact sum;
    bf16 output adds one ulp."""
    din = x.shape[1]
    mag = (x.float().abs() @ tq.unpack_int4(p4, chunks).float().abs()) \
        * scale
    return 2 * din * 2.0 ** -24 * mag


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,din,dout", [
    (1, 64, 128), (4, 64, 192), (8, 128, 384), (3, 96, 160),   # JAX parity
    (1, 4096, 1024), (8, 4096, 4096), (32, 14336, 4096),       # llama-3-8b
    (5, 4096, 14336), (2, 16, 8), (13, 256, 264),
])
def test_q4_matmul_kernel_matches_ref(dtype, rows, din, dout):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(rows * din + dout)
    leaf = tq.quantize_weight_int4(
        torch.randn(din, dout, generator=g, device=dev) / din ** 0.5)
    x = _rand(g, (rows, din), dtype, dev)
    n0 = qm.q4_matmul.launches
    out = qm.q4_matmul(x, leaf["p4"], leaf["scale"])
    torch.cuda.synchronize()
    assert qm.q4_matmul.launches == n0 + 1
    assert out.dtype == dtype and out.shape == (rows, dout)
    ref = qm.q4_matmul_ref(x, leaf["p4"], leaf["scale"])
    bound = q4_bound(x, leaf["p4"], leaf["scale"])
    if dtype == torch.bfloat16:
        bound = bound + 2 ** -7 * ref.float().abs()
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(out.float()).all()
    assert bool((err <= bound).all()), float((err - bound).max())
    again = qm.q4_matmul(x, leaf["p4"], leaf["scale"])
    assert torch.equal(out, again)     # no float atomics: the same bits


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,din,dout,chunks", [
    (2, 128, 256, 2), (3, 128, 256, 2),                        # JAX parity
    (1, 4096, 4096, 2), (8, 4096, 4096, 4), (32, 4096, 4096, 2),   # o
    (1, 14336, 4096, 4), (8, 14336, 4096, 2), (32, 14336, 4096, 4),  # down
    (8, 2048, 4096, 1), (1, 7168, 4096, 1),         # a tp=2 rank's chunk
    (5, 96, 264, 3),                                # odd: 16 rows a chunk
])
def test_q4_matmul_row_kernel_matches_ref(dtype, rows, din, dout, chunks):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(rows * din + dout + chunks)
    leaf = tq.repack_int4_rows(tq.quantize_weight_int4(
        torch.randn(din, dout, generator=g, device=dev) / din ** 0.5), chunks)
    x = _rand(g, (rows, din), dtype, dev)
    n0, m0 = qm.q4_matmul_row.launches, qm.q4_matmul.launches
    out = qm.q4_matmul_row(x, leaf["p4"], leaf["scale"], chunks)
    torch.cuda.synchronize()
    assert qm.q4_matmul_row.launches == n0 + 1
    assert qm.q4_matmul.launches == m0
    assert out.dtype == dtype and out.shape == (rows, dout)
    ref = qm.q4_matmul_row_ref(x, leaf["p4"], leaf["scale"], chunks)
    bound = q4_bound(x, leaf["p4"], leaf["scale"], chunks)
    if dtype == torch.bfloat16:
        bound = bound + 2 ** -7 * ref.float().abs()
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(out.float()).all()
    assert bool((err <= bound).all()), float((err - bound).max())
    again = qm.q4_matmul_row(x, leaf["p4"], leaf["scale"], chunks)
    assert torch.equal(out, again)     # no float atomics: the same bits
    with pytest.raises(ValueError):    # din must split into 2*chunks
        qm.q4_matmul_row(x, leaf["p4"], leaf["scale"], din)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 2, 3, 8, 9, 17, 32])
@pytest.mark.parametrize("din,dout,chunks", [
    (4096, 1024, None),     # k/v: the contraction split over blocks
    (256, 264, None),       # dout % 16 == 8: 8-byte weight copies
    (4096, 4096, 2),        # q4_matmul_row, 2 chunks
    (14336, 4096, 4),       # q4_matmul_row, 4 chunks (down)
    (90, 136, 3),           # odd chunk length 15, ragged k-step
])
def test_q4_matmul_mma_form_edges(rows, din, dout, chunks):
    """bf16 q4_matmul / q4_matmul_row through the tensor-core form (its
    counter moves) at every n-tile count, a masked dout edge, a split
    contraction, chunk-local packs and an odd chunk length, within the
    f32 summation-order bound plus one bf16 ulp; the same bits on a
    second launch."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(rows * din + dout)
    leaf = tq.quantize_weight_int4(
        torch.randn(din, dout, generator=g, device=dev) / din ** 0.5)
    c = chunks or 1
    if chunks:
        leaf = tq.repack_int4_rows(leaf, chunks)
        fn = qm.q4_matmul_row
        call = lambda x: fn(x, leaf["p4"], leaf["scale"], chunks)  # noqa
    else:
        fn = qm.q4_matmul
        call = lambda x: fn(x, leaf["p4"], leaf["scale"])  # noqa: E731
    x = _rand(g, (rows, din), torch.bfloat16, dev)
    assert qm.q4_form(x.dtype, rows) == "mma"
    n0, m0 = fn.launches, fn.launches_mma
    out = call(x)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_mma) == (n0 + 1, m0 + 1)
    ref = qm.q4_matmul_row_ref(x, leaf["p4"], leaf["scale"], c)
    bound = q4_bound(x, leaf["p4"], leaf["scale"], c) \
        + 2 ** -7 * ref.float().abs()
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(out.float()).all()
    assert bool((err <= bound).all()), float((err - bound).max())
    assert torch.equal(out, call(x))   # no float atomics: the same bits


@pytest.mark.cuda
def test_q4_matmul_f32_keeps_the_cuda_core_form():
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(11)
    leaf = tq.quantize_weight_int4(
        torch.randn(256, 512, generator=g, device=dev) / 16)
    x = _rand(g, (8, 256), torch.float32, dev)
    assert qm.q4_form(x.dtype, 8) == "simt"
    n0, m0 = qm.q4_matmul.launches, qm.q4_matmul.launches_mma
    out = qm.q4_matmul(x, leaf["p4"], leaf["scale"])
    torch.cuda.synchronize()
    assert (qm.q4_matmul.launches, qm.q4_matmul.launches_mma) == (n0 + 1, m0)
    ref = qm.q4_matmul_ref(x, leaf["p4"], leaf["scale"])
    assert bool(((out - ref).abs()
                 <= q4_bound(x, leaf["p4"], leaf["scale"])).all())


# ---- the softcap arms (gemma2's cap * tanh(score / cap)) -----------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Hkv,hd,window,alibi,cap", [
    (1, 512, 16, 8, 256, None, False, 50.0),     # gemma-2-9b's heads
    (1, 300, 16, 8, 256, 64, False, 50.0),
    (2, 77, 8, 2, 128, None, False, 1.5),        # odd length, GQA
    (1, 129, 8, 1, 256, 50, False, 1.0),         # MQA, window
    (2, 100, 8, 2, 64, 20, True, 3.0),           # with ALiBi
])
def test_softcap_prefill_matches_ref(dtype, B, S, H, Hkv, hd, window, alibi,
                                     cap):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(S + hd)
    q = _rand(g, (B, S, H, hd), dtype, dev)
    k, v = (_rand(g, (B, S, Hkv, hd), dtype, dev) for _ in range(2))
    sl = alibi_slopes(H, dev) if alibi else None
    kw = dict(sliding_window=window, alibi=sl, softcap=cap)
    out = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref = fa.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))
    uncapped = fa.flash_attention_ref(q, k, v, sliding_window=window,
                                      alibi=sl)
    if cap < 10:   # the cap bites
        assert not torch.allclose(ref.float(), uncapped.float(),
                                  **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths,S,H,Hkv,hd,window,alibi,cap", [
    ([4500], 8192, 16, 8, 256, 4096, False, 50.0),   # past the window
    ([1, 37, 300], 512, 8, 2, 128, None, False, 1.5),
    ([0, 77, 1000], 1024, 8, 1, 256, 100, False, 2.0),
    ([37, 101], 128, 8, 2, 32, None, True, 3.0),
])
def test_softcap_flash_decode_matches_ref(dtype, lengths, S, H, Hkv, hd,
                                          window, alibi, cap):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(S + hd + 1)
    B = len(lengths)
    q = _rand(g, (B, 1, H, hd), dtype, dev)
    k, v = (_rand(g, (B, S, Hkv, hd), dtype, dev) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    sl = alibi_slopes(H, dev) if alibi else None
    kw = dict(sliding_window=window, alibi=sl, softcap=cap)
    out = fa.flash_decode(q, k, v, lens, **kw)
    again = fa.flash_decode(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref = fa.flash_decode_ref(q, k, v, lens, **kw)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths,H,Hkv,hd,window,cap", [
    ([4096] * 8, 16, 8, 256, None, 50.0),        # full occupancy
    ([0, 1, 17, 300, 4500], 16, 8, 256, 4096, 50.0),
    ([255, 256, 257, 513, 0], 8, 2, 128, None, 1.5),
    ([300, 17], 8, 1, 256, 64, 2.0),
])
def test_softcap_paged_decode_matches_ref(dtype, lengths, H, Hkv, hd, window,
                                          cap):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(len(lengths) + hd)
    kp, vp, bt, lens = _paged_case(g, dev, dtype, lengths, H, Hkv, hd, 16)
    q = _rand(g, (len(lengths), 1, H, hd), dtype, dev)
    kw = dict(sliding_window=window, softcap=cap)
    out = pa.paged_flash_decode(q, kp, vp, bt, lens, **kw)
    again = pa.paged_flash_decode(q, kp, vp, bt, lens, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref = pa.paged_flash_decode_ref(q, kp, vp, bt, lens, **kw)
    torch.testing.assert_close(out.float(), ref.float(), **_paged_tol(dtype))


@pytest.mark.cuda
def test_uncapped_kernels_keep_their_bits():
    """Without a cap, flash_attention, flash_decode and paged_flash_decode
    give the bits the kernels gave before the cap arm existed
    (chip_smoke.UNCAPPED_DIGESTS, digests of their outputs on fixed
    inputs, measured on an H100 from the tree without the arm)."""
    _cuda()
    import chip_smoke
    assert chip_smoke.uncapped_digests(torch) == chip_smoke.UNCAPPED_DIGESTS
