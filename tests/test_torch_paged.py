"""The port's paged attention, fused decode and paged model entry points
against the JAX package's, on the CPU.

- ``paged_flash_decode``: the JAX Pallas kernel in interpret mode against
  the port's wrapper on CPU tensors (its plain version), over the cases
  of tests/test_pallas_parity.py plus a row of length 0. f32, 2e-5.
- the split-KV arithmetic of the CUDA kernel
  (``paged_flash_decode_split_ref``: per-range partials merged by
  ``merge_partials``) against ``paged_flash_decode_ref`` and the JAX
  kernel in interpret mode, at split edges, length 0, tables far wider
  than every length and windows inside and across ranges. f32, 1e-5.
- ``fused_decode_step`` (float form): the JAX kernel in interpret mode
  against the port over GQA/MQA/MHA with RoPE, and no RoPE with a window.
  f32, 3e-5 (the kernel's own parity bar in the JAX suite). The gate
  (``supported``/``eligible``) gives the JAX package's verdicts.
- the CUDA kernel's cluster decomposition
  (``fused_decode_step_cluster_model``) against the JAX kernel in
  interpret mode and ``fused_decode_step_ref``: R=1 and above one row
  group, length 0, item edges, windows inside and across items, D not a
  multiple of the cluster's slices, MHA/GQA/MQA. f32, 3e-5. The form
  rule by dtype (``fused_form``) is pinned.
- ``paged_prefill_tail`` + ``paged_decode_step`` on tiny-llama f32 with
  weights bridged from the JAX tree: logits and the pool after the writes
  within 1e-4 (f32 matmuls in another summation order, 4 layers), with a
  cached prefix and with the fused route on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inferencing_tpu.models.params import (
    init_params as jax_init_params)
from distributed_llm_inferencing_tpu.models.registry import (
    get_config as jax_config)
from distributed_llm_inferencing_tpu.ops.paged_kvcache import (
    init_paged_cache as jax_init_paged)
from distributed_llm_inferencing_tpu.ops.pallas import fused_decode as jfd
from distributed_llm_inferencing_tpu.ops.pallas.paged_attention import (
    paged_flash_decode as jax_paged_flash_decode)
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.models.registry import get_config
from distributed_llm_inferencing_tpu_torch.models.transformer import (
    Transformer)
from distributed_llm_inferencing_tpu_torch.ops import fused_decode as tfd
from distributed_llm_inferencing_tpu_torch.ops import paged_kvcache as tpk
from distributed_llm_inferencing_tpu_torch.ops.paged_attention import (
    PAGED_SPLIT, merge_partials, num_splits, paged_flash_decode,
    paged_flash_decode_ref, paged_flash_decode_split_ref)
from test_torch_families import (  # noqa: F401
    jit_paged_decode_step, jit_paged_prefill_tail, one_torch_thread)

KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
FUSED_TOL = dict(rtol=3e-5, atol=3e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
SPLIT_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pool(rng, nb, bs, hkv, hd):
    return (rng.normal(size=(nb, bs, hkv, hd)).astype(np.float32),
            rng.normal(size=(nb, bs, hkv, hd)).astype(np.float32))


def _tables(rng, r, mb, nb):
    """Distinct random pool blocks per slot; block 0 stays the dummy."""
    return (rng.permutation(nb - 1)[:r * mb] + 1).reshape(r, mb) \
        .astype(np.int32)


@pytest.mark.parametrize("lens,window", [
    ([5, 17, 32, 1], None),        # masked tails mid-block + full + 1
    ([9, 9, 9, 9], None),          # uniform
    ([31, 2, 16, 7], None),        # block boundary - 1 / cross-block mix
    ([20, 13], 6),                 # sliding window
    ([0, 11, 24], None),           # a row of length 0 (an inactive slot)
])
def test_paged_flash_decode_matches_pallas_interpret(lens, window):
    rng = np.random.default_rng(sum(lens) + (window or 0))
    r, nb, bs, mb, h, hkv, hd = len(lens), 32, 8, 4, 4, 2, 16
    k_pool, v_pool = _pool(rng, nb, bs, hkv, hd)
    bt = _tables(rng, r, mb, nb)
    q = rng.normal(size=(r, 1, h, hd)).astype(np.float32)
    lens_a = np.asarray(lens, np.int32)
    ref = jax_paged_flash_decode(jnp.asarray(q), jnp.asarray(k_pool),
                                 jnp.asarray(v_pool), jnp.asarray(bt),
                                 jnp.asarray(lens_a), sliding_window=window,
                                 interpret=True)
    args = (_t(q), _t(k_pool), _t(v_pool), _t(bt), _t(lens_a))
    out = paged_flash_decode(*args, sliding_window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_TOL)
    plain = paged_flash_decode_ref(*args, sliding_window=window)
    np.testing.assert_array_equal(out.numpy(), plain.numpy())
    # the dispatch the model calls lands on the same function
    via = tpk.paged_attend_decode(*args, sliding_window=window)
    np.testing.assert_array_equal(via.numpy(), out.numpy())


@pytest.mark.parametrize("lens,mb,window,split", [
    ([15, 16, 17, 33], 5, None, 16),   # split - 1, split, split + 1, 2*split + 1
    ([0, 5, 40], 12, None, 16),        # length 0; MB*bs far beyond every length
    ([40, 17, 3], 6, 6, 16),           # a window shorter than a split
    ([45, 33, 20], 6, 20, 16),         # a window spanning splits
    ([31, 1, 0], 4, None, PAGED_SPLIT),   # the kernel's split: one live range
])
def test_paged_split_arithmetic_matches_ref_and_pallas(lens, mb, window,
                                                       split):
    rng = np.random.default_rng(sum(lens) + mb + (window or 0))
    r, bs, h, hkv, hd = len(lens), 8, 4, 2, 16
    nb = r * mb + 1
    k_pool, v_pool = _pool(rng, nb, bs, hkv, hd)
    bt = _tables(rng, r, mb, nb)
    q = rng.normal(size=(r, 1, h, hd)).astype(np.float32)
    lens_a = np.asarray(lens, np.int32)
    jax_out = jax_paged_flash_decode(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(bt), jnp.asarray(lens_a), sliding_window=window,
        interpret=True)
    args = (_t(q), _t(k_pool), _t(v_pool), _t(bt), _t(lens_a))
    out = paged_flash_decode_split_ref(*args, sliding_window=window,
                                       split=split)
    assert num_splits(mb, bs, split) == -(-(mb * bs) // split)
    np.testing.assert_allclose(
        out.numpy(), paged_flash_decode_ref(
            *args, sliding_window=window).numpy(), **SPLIT_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_out), **SPLIT_TOL)
    for i, n in enumerate(lens):
        assert (torch.count_nonzero(out[i]) == 0) == (n == 0)


def test_merge_partials_ignores_empty_ranges():
    """An empty range (l = 0) is never read, whatever its m and acc hold;
    a row whose ranges are all empty comes out 0."""
    m = torch.tensor([[1.0, float("-inf"), 0.5], [float("-inf")] * 3])
    l = torch.tensor([[2.0, 0.0, 1.0], [0.0] * 3])
    acc = torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(0))
    acc[:, 1] = float("nan")
    out = merge_partials(m, l, acc)
    w = torch.exp(torch.tensor([0.0, -0.5]))
    want = (w[0] * acc[0, 0] + w[1] * acc[0, 2]) / (w[0] * 2.0 + w[1] * 1.0)
    torch.testing.assert_close(out[0], want)
    assert torch.equal(out[1], torch.zeros(4))


def test_rope_rows_match_jax():
    cfg_t = get_config("tiny-llama")
    cfg_j = jax_config("tiny-llama")
    pos = np.asarray([0, 7, 31, 95], np.int32)
    jc, js = jfd.rope_cos_sin(cfg_j, jnp.asarray(pos), 16)
    tc, ts = tfd.rope_cos_sin(cfg_t, _t(pos), 16)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("gqa,rope,window", [
    ("gqa", True, None), ("mqa", True, None), ("mha", True, None),
    ("gqa", False, 5),
])
def test_fused_decode_step_matches_pallas_interpret(gqa, rope, window):
    cfg_j = jax_config("tiny-llama").replace(dtype="float32")
    cfg_t = get_config("tiny-llama").replace(dtype="float32")
    rng = np.random.default_rng({"gqa": 1, "mqa": 2, "mha": 3}[gqa]
                                + 10 * rope)
    hkv = {"gqa": 2, "mqa": 1, "mha": 4}[gqa]
    r, nb, bs, mb, h, hd, d = 3, 16, 8, 3, 4, 16, 32
    k_pool, v_pool = _pool(rng, nb, bs, hkv, hd)
    bt = _tables(rng, r, mb, nb)
    lens = np.asarray([7, 21, 12], np.int32)
    x = rng.normal(size=(r, d)).astype(np.float32)
    w = (rng.normal(size=(d, h * hd)) / np.sqrt(d)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if rope:
        cos, sin = jfd.rope_cos_sin(cfg_j, jnp.asarray(lens - 1), hd)
        kw_j = dict(rope_cos=cos, rope_sin=sin)
        kw_t = dict(zip(("rope_cos", "rope_sin"),
                        tfd.rope_cos_sin(cfg_t, _t(lens - 1), hd)))
    ref = jfd.fused_decode_step(
        jnp.asarray(x), {"w": jnp.asarray(w)}, jnp.asarray(k_pool),
        jnp.asarray(v_pool), jnp.asarray(bt), jnp.asarray(lens),
        sliding_window=window, interpret=True, **kw_j)
    out = tfd.fused_decode_step(
        _t(x), {"w": _t(w)}, _t(k_pool), _t(v_pool), _t(bt), _t(lens),
        sliding_window=window, **kw_t)
    assert out.shape == (r, h, hd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FUSED_TOL)


# The cluster kernel's decomposition (fused_decode_step_cluster_model):
# (lens, h, hkv, d, window, rope, cluster, teams, split). R=1; R above one
# row group of 8; length 0 and lengths at item edges; a window inside one
# item and one across items; D=40, not a multiple of cluster x 16 rows;
# MHA, GQA and MQA (G = 8: two head groups of 4).
CLUSTER_CASES = [
    ([21], 4, 2, 32, None, True, 16, 2, 16),
    ([0, 7, 15, 16, 17, 33, 3, 30, 12], 4, 2, 32, None, True, 3, 2, 16),
    ([15, 16, 17, 0, 31, 32, 33], 4, 2, 32, None, True, 2, 1, 16),
    ([40, 17, 3], 4, 2, 32, 6, True, 2, 2, 16),
    ([45, 33, 20], 4, 2, 32, 20, False, 2, 2, 16),
    ([29, 11], 4, 2, 40, None, True, 16, 2, 16),
    ([25, 9, 0], 4, 4, 32, None, True, 3, 2, 16),
    ([25, 9, 18], 8, 1, 32, 10, True, 3, 2, 8),
]


def cluster_case(rng, lens, h, hkv, d, hd=16, bs=8):
    """Pools, tables, x and an f32 q weight for one cluster-model case."""
    r = len(lens)
    mb = max(1, -(-max(lens) // bs))
    nb = r * mb + 1
    k_pool, v_pool = _pool(rng, nb, bs, hkv, hd)
    bt = _tables(rng, r, mb, nb)
    x = rng.normal(size=(r, d)).astype(np.float32)
    w = (rng.normal(size=(d, h * hd)) / np.sqrt(d)).astype(np.float32)
    return x, w, k_pool, v_pool, bt, np.asarray(lens, np.int32)


def cluster_rope(rope, lens, hd=16):
    """The JAX and the port's RoPE rows at each slot's position."""
    if not rope:
        return {}, {}
    cfg_j = jax_config("tiny-llama").replace(dtype="float32")
    cfg_t = get_config("tiny-llama").replace(dtype="float32")
    cos, sin = jfd.rope_cos_sin(cfg_j, jnp.asarray(lens - 1), hd)
    return (dict(rope_cos=cos, rope_sin=sin),
            dict(zip(("rope_cos", "rope_sin"),
                     tfd.rope_cos_sin(cfg_t, _t(lens - 1), hd))))


@pytest.mark.parametrize("lens,h,hkv,d,window,rope,cluster,teams,split",
                         CLUSTER_CASES)
def test_fused_cluster_model_matches_pallas_and_ref(lens, h, hkv, d, window,
                                                    rope, cluster, teams,
                                                    split):
    """The kernel's decomposition (rank slices of the contraction summed
    in order, key spans per worker, per-worker then cross-worker
    log-sum-exp merges) against the JAX kernel in interpret mode and the
    plain version, float form, f32 at the fused bar."""
    rng = np.random.default_rng(100 * len(lens) + d + 7 * h + hkv)
    x, w, k_pool, v_pool, bt, lens_a = cluster_case(rng, lens, h, hkv, d)
    kw_j, kw_t = cluster_rope(rope, lens_a)
    ref = jfd.fused_decode_step(
        jnp.asarray(x), {"w": jnp.asarray(w)}, jnp.asarray(k_pool),
        jnp.asarray(v_pool), jnp.asarray(bt), jnp.asarray(lens_a),
        sliding_window=window, interpret=True, **kw_j)
    args = (_t(x), {"w": _t(w)}, _t(k_pool), _t(v_pool), _t(bt),
            _t(lens_a))
    out = tfd.fused_decode_step_cluster_model(
        *args, sliding_window=window, cluster=cluster, teams=teams,
        split=split, **kw_t)
    plain = tfd.fused_decode_step_ref(*args, sliding_window=window, **kw_t)
    assert out.shape == (len(lens), h, 16) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FUSED_TOL)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), **FUSED_TOL)
    for i, n in enumerate(lens):
        assert (torch.count_nonzero(out[i]) == 0) == (n == 0)


def test_fused_form_picks_by_dtype():
    """The kernel's projection form is a rule by x's dtype alone: bf16 on
    the tensor cores, f32 on the CUDA cores; the contraction slices are
    whole ring stages of the form."""
    assert tfd.fused_form(torch.bfloat16) == "mma"
    assert tfd.fused_form(torch.float32) == "fma"
    assert [tfd.fused_stage_rows(torch.bfloat16, f)
            for f in ("float", "int8", "int4")] == [16, 32, 32]
    assert [tfd.fused_stage_rows(torch.float32, f)
            for f in ("float", "int8", "int4")] == [8, 32, 32]


def test_fused_quantized_forms_are_refused():
    """Chunk-local int4 packs (the JAX package's row-parallel layout) and
    leaves of no known form are refused; the int8 and int4 forms run."""
    z = torch.zeros(2, 32)
    pool = torch.zeros(4, 8, 2, 16)
    bt = torch.ones(2, 1, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    scale = torch.ones(64)
    chunked = {"p4": torch.zeros(16, 64, dtype=torch.uint8), "scale": scale,
               "chunked": torch.zeros(2, 0, dtype=torch.int8)}
    with pytest.raises(NotImplementedError):
        tfd.fused_decode_step(z, chunked, pool, pool, bt, lens)
    with pytest.raises(ValueError):
        tfd.fused_decode_step(z, {"q": z, "p4": z}, pool, pool, bt, lens)
    for leaf in ({"q": torch.zeros(32, 64, dtype=torch.int8), "scale": scale},
                 {"p4": torch.full((16, 64), 0x88, dtype=torch.uint8),
                  "scale": scale}):
        out = tfd.fused_decode_step(z, leaf, pool, pool, bt, lens)
        assert out.shape == (2, 4, 16) and (out == 0).all()


@pytest.mark.parametrize("over,leaf", [
    ({}, None),
    ({"qk_norm": "rms_head"}, None),
    ({"rope_interleaved": True}, None),
    ({"attn_softcap": 30.0}, None),
    ({"kv_quant": "int8"}, None),
    ({}, {"w": None, "b": None}),          # biased q leaf
    ({"position_embedding": "alibi"}, None),
    ({"rope_pct": 0.5}, None),
])
def test_fused_gate_matches_jax(monkeypatch, over, leaf):
    cfg_j = jax_config("tiny-llama").replace(**over)
    cfg_t = get_config("tiny-llama").replace(**over)
    assert tfd.supported(cfg_t, leaf) == jfd.supported(cfg_j, leaf)
    for env in ("0", "1"):
        monkeypatch.setenv("DLI_FUSED_DECODE", env)
        assert tfd.enabled() == jfd.enabled()
        for quantized in (False, True):
            # the JAX gate also asks for one device; the port runs on one
            # GPU, so its gate is the JAX one without that clause
            want = (jfd.enabled() and not quantized
                    and jfd.supported(cfg_j))
            assert tfd.eligible(cfg_t, quantized) == want


# ---- the paged model entry points -----------------------------------

NB, BS = 24, 8


def _models():
    jcfg = jax_config("tiny-llama").replace(dtype="float32",
                                            attn_backend="xla")
    params = jax_init_params(jcfg, jax.random.PRNGKey(7))
    tcfg = get_config("tiny-llama").replace(dtype="float32")
    tp = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, params, Transformer(tcfg, tp)


def _pools_close(jp, tp):
    np.testing.assert_allclose(tp.k.numpy(), np.asarray(jp.k), **MODEL_TOL)
    np.testing.assert_allclose(tp.v.numpy(), np.asarray(jp.v), **MODEL_TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_paged_prefill_and_decode_match_jax(monkeypatch, fused):
    monkeypatch.setenv("DLI_FUSED_DECODE", "1" if fused else "0")
    jcfg, jparams, model = _models()
    rng = np.random.default_rng(4)
    V = jcfg.vocab_size
    jpaged = jax_init_paged(jcfg, NB, BS)
    tpaged = tpk.init_paged_cache(model.cfg, NB, BS, device="cpu")

    def both_prefill(toks, tail_len, tail_blocks, pfb, pfl):
        nonlocal jpaged
        args = [np.asarray(a, np.int32)
                for a in (toks, tail_len, tail_blocks, pfb, pfl)]
        jl, jpaged = jit_paged_prefill_tail(
            jparams, jcfg, *[jnp.asarray(a) for a in args], jpaged)
        with torch.inference_mode():
            tl, _ = model.paged_prefill_tail(
                _t(args[0]).long(), *[_t(a) for a in args[1:]], tpaged)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        _pools_close(jpaged, tpaged)

    # 1) a 16-token prompt into blocks 1, 2 (no prefix); 2) a wave of two
    # tails: row 0 reuses that prompt's two blocks as its cached prefix
    prompt = rng.integers(0, V, 16)
    both_prefill(prompt[None], [16], [[1, 2]], [[0, 0]], [0])
    tails = np.zeros((2, 16), np.int64)
    tails[0, :5] = rng.integers(0, V, 5)
    tails[1, :11] = rng.integers(0, V, 11)
    both_prefill(tails, [5, 11], [[3, 4], [5, 6]], [[1, 2], [0, 0]],
                 [16, 0])

    # decode: slot 0 continues the prefixed row (context 21, blocks
    # 1,2,3 + growth 7), slot 1 the fresh row (11, blocks 5,6), slot 2 is
    # inactive (dummy block, context 0)
    bt = np.asarray([[1, 2, 3, 7], [5, 6, 8, 0], [0, 0, 0, 0]], np.int32)
    cl = np.asarray([21, 11, 0], np.int32)
    for _ in range(4):   # teacher-forced
        toks = rng.integers(0, V, 3).astype(np.int32)
        jl, jpaged = jit_paged_decode_step(
            jparams, jcfg, jnp.asarray(toks), jpaged, jnp.asarray(bt),
            jnp.asarray(cl))
        with torch.inference_mode():
            tl, _ = model.paged_decode_step(_t(toks).long(), tpaged,
                                            _t(bt), _t(cl))
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                                   **MODEL_TOL)
        cl[:2] += 1
    # the dummy block takes the inactive slot's garbage writes
    jk, tk = np.asarray(jpaged.k)[:, 1:], tpaged.k[:, 1:].numpy()
    np.testing.assert_allclose(tk, jk, **MODEL_TOL)
    np.testing.assert_allclose(tpaged.v[:, 1:].numpy(),
                               np.asarray(jpaged.v)[:, 1:], **MODEL_TOL)


def test_paged_writes_are_in_place():
    cfg = get_config("tiny-llama").replace(dtype="float32")
    paged = tpk.init_paged_cache(cfg, 6, 4, device="cpu")
    layer = paged.k[1]
    new = torch.arange(2 * 4 * 8, dtype=torch.float32).reshape(2, 4, 8)
    tpk.write_token(layer, new, torch.tensor([[2, 3], [4, 5]],
                                             dtype=torch.int32),
                    torch.tensor([5, 2], dtype=torch.int32))
    assert torch.equal(paged.k[1, 3, 1], new[0])     # pos 5 -> block 3
    assert torch.equal(paged.k[1, 4, 2], new[1])     # pos 2 -> block 4
    run = torch.ones(1, 8, 4, 8)
    tpk.write_block_run(layer, run, torch.tensor([[1, 5]],
                                                 dtype=torch.int32))
    assert (paged.k[1, 1] == 1).all() and (paged.k[1, 5] == 1).all()
    g = tpk.gather_seq(layer, torch.tensor([[5, 1]], dtype=torch.int32))
    assert g.shape == (1, 8, 4, 8) and (g == 1).all()
    # the int8 pool's scale planes are written in place too
    q8 = tpk.init_paged_cache(cfg.replace(kv_quant="int8"), 6, 4)
    scales = q8.k_scale[1]
    tpk.write_token(scales, torch.full((2, 4), 0.5),
                    torch.tensor([[2, 3], [4, 5]], dtype=torch.int32),
                    torch.tensor([5, 2], dtype=torch.int32))
    assert (q8.k_scale[1, 3, 1] == 0.5).all() and scales.data_ptr() == \
        q8.k_scale[1].data_ptr()
    with pytest.raises(ValueError):
        tpk.init_paged_cache(cfg.replace(kv_quant="fp8"), 6, 4)


def test_repeated_writes_leave_one_value_per_place():
    """Inactive and dead slots and padding rows all write the reserved
    dummy block (block 0 here): every place gets its first writer's
    value, so the block's bits do not hang on which of the repeated
    writes a card's scatter lands last."""
    places = torch.tensor([5, 3, 5, 7, 3, 3, 9])
    assert tpk.first_writers(places).tolist() == [0, 1, 0, 3, 1, 1, 6]
    cfg = get_config("tiny-llama").replace(dtype="float32")
    paged = tpk.init_paged_cache(cfg, 6, 4, device="cpu")
    layer = paged.k[0]
    new = torch.arange(4 * 4 * 8, dtype=torch.float32).reshape(4, 4, 8)
    tables = torch.tensor([[0, 0], [2, 3], [0, 0], [0, 0]],
                          dtype=torch.int32)
    positions = torch.tensor([1, 6, 1, 1], dtype=torch.int32)
    writers = tpk.token_writers(tables, positions, 4)
    assert writers.tolist() == [0, 1, 0, 0]
    # every row that writes a place carries the same value there
    same = tpk.one_per_place(new, torch.tensor([1, 14, 1, 1]), 0)
    assert torch.equal(same[2], new[0]) and torch.equal(same[3], new[0])
    tpk.write_token(layer, new, tables, positions)
    assert torch.equal(paged.k[0, 0, 1], new[0])      # the dummy block
    assert torch.equal(paged.k[0, 3, 2], new[1])      # pos 6 -> block 3
    before = paged.k.clone()
    tpk.write_token(layer, new, tables, positions, writers)
    assert torch.equal(paged.k, before)               # writers given
    run = torch.arange(3 * 8 * 4 * 8, dtype=torch.float32).reshape(
        3, 8, 4, 8)
    tpk.write_block_run(layer, run, torch.tensor([[4, 0], [0, 0], [5, 0]],
                                                 dtype=torch.int32))
    assert torch.equal(paged.k[0, 0], run[0, 4:])     # row 0's padding
    assert torch.equal(paged.k[0, 4], run[0, :4])
    assert torch.equal(paged.k[0, 5], run[2, :4])
