"""The port's flash-attention module against the JAX Pallas kernels.

``flash_attention_ref`` / ``flash_decode_ref`` (the CUDA kernels' plain
versions) must compute what the reference's ``flash_attention`` /
``flash_decode`` compute, run here in Pallas interpret mode, over the
cases of tests/test_pallas_attention.py. f32 throughout: rtol = atol =
2e-5, the tolerance that file holds the Pallas kernels to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inferencing_tpu.ops.attention import alibi_slopes
from distributed_llm_inferencing_tpu.ops.pallas import (
    flash_attention as jax_flash_attention, flash_decode as jax_flash_decode)
from distributed_llm_inferencing_tpu_torch.ops import flash_attention as fa
from test_torch_families import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(rng, *shape):
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("B,S,H,Hkv,hd,window,alibi,block", [
    (2, 64, 8, 4, 64, None, False, 32),     # GQA
    (1, 32, 4, 4, 32, None, False, 32),     # MHA, small head_dim
    (2, 128, 8, 1, 64, None, False, 32),    # MQA
    (2, 64, 4, 2, 32, 16, False, 16),       # sliding window
    (1, 48, 2, 2, 16, None, False, 32),     # S not a block multiple
    (2, 64, 4, 4, 32, None, True, 16),      # ALiBi
])
def test_flash_attention_ref_matches_pallas(B, S, H, Hkv, hd, window, alibi,
                                            block):
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = (_rand(rng, B, S, H, hd),
                                    _rand(rng, B, S, Hkv, hd),
                                    _rand(rng, B, S, Hkv, hd))
    sl = alibi_slopes(H) if alibi else None
    ref = jax_flash_attention(jq, jk, jv, sliding_window=window, alibi=sl,
                              block_q=block, block_kv=block, interpret=True)
    out = fa.flash_attention_ref(
        tq, tk, tv, sliding_window=window,
        alibi=torch.tensor(np.asarray(sl)) if alibi else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("lengths,H,Hkv,window,alibi", [
    ([37, 90], 8, 4, None, False),
    ([1, 128], 8, 4, None, False),
    ([128, 64], 8, 4, None, False),
    ([50, 20], 4, 2, 8, False),            # sliding window
    ([37, 101], 4, 4, None, True),         # ALiBi, MHA
    ([37, 101], 8, 2, None, True),         # ALiBi, grouped
    ([5, 77], 8, 1, None, False),          # MQA
])
def test_flash_decode_ref_matches_pallas(lengths, H, Hkv, window, alibi):
    rng = np.random.default_rng(3)
    B, S, hd = 2, 128, 64
    (jq, tq), (jk, tk), (jv, tv) = (_rand(rng, B, 1, H, hd),
                                    _rand(rng, B, S, Hkv, hd),
                                    _rand(rng, B, S, Hkv, hd))
    sl = alibi_slopes(H) if alibi else None
    lens = np.asarray(lengths, np.int32)
    ref = jax_flash_decode(jq, jk, jv, jnp.asarray(lens),
                           sliding_window=window, alibi=sl, block_kv=32,
                           interpret=True)
    out = fa.flash_decode_ref(
        tq, tk, tv, torch.from_numpy(lens), sliding_window=window,
        alibi=torch.tensor(np.asarray(sl)) if alibi else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


SPLIT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lengths,S,H,Hkv,window,alibi,split", [
    ([15, 16, 17, 33], 64, 8, 4, None, False, 16),   # split -1, 0, +1
    ([0, 5, 40], 256, 8, 2, None, False, 16),    # length 0; S far beyond
    ([40, 17, 3], 64, 8, 2, 6, False, 16),       # a window under a split
    ([45, 33, 20], 64, 4, 4, 20, False, 16),     # a window across splits
    ([37, 101], 128, 8, 2, None, True, 32),      # ALiBi, grouped
    ([64, 1, 0], 64, 4, 1, None, True, 64),      # MQA, ALiBi, one range
])
def test_flash_decode_split_arithmetic_matches_ref_and_pallas(
        lengths, S, H, Hkv, window, alibi, split):
    """flash_decode_split_ref (the split kernel's cut: per-range partials,
    then merge_partials) against flash_decode_ref and the JAX kernel in
    interpret mode, f32."""
    rng = np.random.default_rng(sum(lengths) + S + split)
    B, hd = len(lengths), 16
    (jq, tq), (jk, tk), (jv, tv) = (_rand(rng, B, 1, H, hd),
                                    _rand(rng, B, S, Hkv, hd),
                                    _rand(rng, B, S, Hkv, hd))
    sl = alibi_slopes(H) if alibi else None
    tsl = torch.tensor(np.asarray(sl)) if alibi else None
    lens = np.asarray(lengths, np.int32)
    ref = jax_flash_decode(jq, jk, jv, jnp.asarray(lens),
                           sliding_window=window, alibi=sl, block_kv=16,
                           interpret=True)
    args = (tq, tk, tv, torch.from_numpy(lens))
    out = fa.flash_decode_split_ref(*args, sliding_window=window,
                                    alibi=tsl, split=split)
    np.testing.assert_allclose(
        out.numpy(), fa.flash_decode_ref(*args, sliding_window=window,
                                         alibi=tsl).numpy(), **SPLIT_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SPLIT_TOL)
    for i, n in enumerate(lengths):
        assert (torch.count_nonzero(out[i]) == 0) == (n == 0)


@pytest.mark.parametrize("B,H,Hkv,S,sms,split", [
    (1, 32, 8, 4096, 132, 128),    # the engine, llama-3-8b: 256 blocks
    (1, 16, 4, 4096, 132, 128),    # a tp=2 rank: 128 blocks
    (4, 32, 8, 4096, 132, 128),    # 1024 blocks
    (1, 32, 8, 512, 132, 64),      # 32 blocks at 128 keys: halved
    (1, 32, 8, 65536, 132, 1024),  # at most 64 partials a row
    (2, 32, 8, 16384, 132, 256),
])
def test_decode_split_from_shapes_alone(B, H, Hkv, S, sms, split):
    """The split length comes from shapes alone (no lengths): 128 keys,
    64 where half the SMs would idle, longer past 64 splits a row."""
    assert fa.decode_split(B, H, Hkv, S, sms) == split


def test_wrappers_take_the_plain_version_on_cpu_without_counting():
    rng = np.random.default_rng(5)
    _, q = _rand(rng, 1, 16, 4, 8)
    _, k = _rand(rng, 1, 16, 2, 8)
    lens = torch.tensor([9], dtype=torch.int32)
    count = lambda: (fa.flash_attention.launches,  # noqa: E731
                     fa.flash_attention.launches_mma,
                     fa.flash_decode.launches)
    before = count()
    assert torch.equal(fa.flash_attention(q, k, k),
                       fa.flash_attention_ref(q, k, k))
    assert torch.equal(fa.flash_decode(q[:, :1], k, k, lens),
                       fa.flash_decode_ref(q[:, :1], k, k, lens))
    assert count() == before


@pytest.mark.parametrize("dtype,hd,form", [
    (torch.bfloat16, 128, "mma"), (torch.bfloat16, 16, "mma"),
    (torch.bfloat16, 256, "mma"), (torch.bfloat16, 8, "simt"),
    (torch.bfloat16, 40, "simt"), (torch.float32, 128, "simt"),
])
def test_prefill_form_picks_by_dtype_and_head_dim(dtype, hd, form):
    """bf16 with head_dim % 16 == 0 takes the tensor-core kernel; f32 and
    other head dims the CUDA-core one."""
    assert fa.prefill_form(dtype, hd) == form


def test_decode_ref_zero_length_row_is_zero():
    """A row with no admissible key writes 0 (the kernels' l == 0 rule)."""
    rng = np.random.default_rng(6)
    _, q = _rand(rng, 2, 1, 4, 8)
    _, k = _rand(rng, 2, 16, 4, 8)
    out = fa.flash_decode_ref(q, k, k, torch.tensor([0, 3], dtype=torch.int32))
    assert torch.count_nonzero(out[0]) == 0
    assert torch.count_nonzero(out[1]) > 0


def test_bf16_ref_matches_pallas_interpret():
    rng = np.random.default_rng(7)
    B, S, H, Hkv, hd = 1, 64, 4, 2, 64
    qs = [rng.normal(size=s).astype(np.float32)
          for s in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]
    jx = [jnp.asarray(a, jnp.bfloat16) for a in qs]
    tx = [torch.from_numpy(a).to(torch.bfloat16) for a in qs]
    ref = jax_flash_attention(*jx, block_q=32, block_kv=32, interpret=True)
    out = fa.flash_attention_ref(*tx)
    assert out.dtype == torch.bfloat16
    # both round one f32 result to bf16: at most one bf16 ulp (2^-7 rel)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=1e-2, atol=1e-2)
