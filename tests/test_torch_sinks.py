"""Attention sinks (gpt-oss) in the port against the JAX package (CPU, f32).

- ``attend`` with a sink column against the JAX ``attend`` within 1e-6 in
  every regime the serving paths use: the generic formulation, the
  prefill, single-token and multi-token (verify) decode over the dense
  cache, paged decode (the gather route) and the paged tail prefill,
  each with and without a window, GQA and MHA, and a row with no
  admissible key (the sink takes all the mass: output 0).
- A tiny gpt-oss variant of tiny-mixtral (sinks, q/k/v/o biases, the
  topk_softmax router, expert biases, the clamped GLU at a limit that
  bites, windows of 8 on alternate layers): prefill and decode logits
  within 1e-4 of the JAX package's on the dense path and on the paged
  path; engine, batcher and speculative batcher greedy tokens equal to
  the JAX engine's and batcher's.
- No attention kernel runs for a sinks model: the kernels' entry points
  are never called (the card's launch counts say the same, chip_smoke.py
  phase 20).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inferencing_tpu.ops import attention as jatt
from distributed_llm_inferencing_tpu.ops import paged_kvcache as jpk
from distributed_llm_inferencing_tpu.ops.kvcache import (
    init_cache as jax_init_cache)
from distributed_llm_inferencing_tpu.ops.paged_kvcache import (
    init_paged_cache as jax_init_paged)
from distributed_llm_inferencing_tpu.ops.sampling import (
    SamplingParams as JaxSamplingParams)
from distributed_llm_inferencing_tpu.runtime.batcher import (
    ContinuousBatcher as JaxBatcher)
from distributed_llm_inferencing_tpu.runtime.engine import (
    InferenceEngine as JaxEngine)
from distributed_llm_inferencing_tpu_torch.models import transformer as ttf
from distributed_llm_inferencing_tpu_torch.ops import attention as tatt
from distributed_llm_inferencing_tpu_torch.ops import paged_kvcache as tpk
from distributed_llm_inferencing_tpu_torch.ops.kvcache import init_cache
from distributed_llm_inferencing_tpu_torch.ops.paged_kvcache import (
    init_paged_cache)
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from test_torch_families import (  # noqa: F401
    jit_decode_step, jit_paged_decode_step, jit_paged_prefill_tail,
    jit_prefill, one_torch_thread)
from test_torch_routers import cfgs, trees

ATOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-4)
GPT_OSS = dict(moe_router="topk_softmax", attn_sinks=True, mlp_bias=True,
               attn_bias=True, moe_swiglu_limit=0.5, attn_windows=(8, None))
POOL = dict(num_blocks=128, block_size=8, slots=4, max_seq=96, seed=0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(rng, B, Sq, Skv, H, Hkv, hd=16):
    return (rng.normal(size=(B, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, hd)).astype(np.float32))


HEADS = [(8, 2), (4, 4)]
WINDOWS = [None, 5]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("H,Hkv", HEADS)
def test_attend_with_sinks_matches_jax(H, Hkv, window):
    """The generic formulation; row 1 has no admissible key (its query
    sits before every valid slot)."""
    rng = np.random.default_rng(0)
    B, Sq, Skv = 2, 6, 20
    q, k, v = _qkv(rng, B, Sq, Skv, H, Hkv)
    sinks = rng.normal(0, 2, H).astype(np.float32)
    qpos = np.stack([np.arange(8, 8 + Sq), np.arange(0, Sq)]).astype(np.int32)
    kvpos = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    valid = np.stack([kvpos[0] < 15, kvpos[1] >= 10])
    want = jatt.attend(*map(jnp.asarray, (q, k, v, qpos, kvpos, valid)),
                       sliding_window=window, sinks=jnp.asarray(sinks))
    got = tatt.attend(*map(_t, (q, k, v, qpos, kvpos, valid)),
                      sliding_window=window, sinks=_t(sinks))
    np.testing.assert_allclose(got.numpy(), want, **ATOL)
    assert not got[1].any()   # all the mass on the sink


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("H,Hkv", HEADS)
def test_dense_regimes_with_sinks_match_jax(H, Hkv, window):
    """Prefill, single-token decode and multi-token decode (the verify
    step's per-query positions) over the dense cache."""
    rng = np.random.default_rng(1)
    B, S = 2, 12
    sinks = rng.normal(0, 2, H).astype(np.float32)
    q, k, v = _qkv(rng, B, S, S, H, Hkv)
    kw = dict(sliding_window=window)
    np.testing.assert_allclose(
        tatt.attend_prefill(_t(q), _t(k), _t(v), sinks=_t(sinks),
                            **kw).numpy(),
        jatt.attend_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            sinks=jnp.asarray(sinks), **kw), **ATOL)
    lens = np.asarray([12, 7], np.int32)
    for sq in (1, 3):
        qd = q[:, :sq]
        qpos = (lens[:, None] - sq + np.arange(sq)).astype(np.int32)
        want = jatt.attend_decode(
            jnp.asarray(qd), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lens), q_positions=jnp.asarray(qpos),
            sinks=jnp.asarray(sinks), **kw)
        got = tatt.attend_decode(
            _t(qd), _t(k), _t(v), _t(lens),
            q_positions=None if sq == 1 else _t(qpos), sinks=_t(sinks),
            **kw)
        np.testing.assert_allclose(got.numpy(), want, **ATOL)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("H,Hkv", HEADS)
def test_paged_regimes_with_sinks_match_jax(H, Hkv, window):
    """Paged decode (the gather route) and the paged tail prefill."""
    rng = np.random.default_rng(2)
    nb, bs, hd, R, MB = 16, 4, 16, 3, 5
    kp = rng.normal(size=(nb, bs, Hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, Hkv, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, nb))[:R * MB].reshape(R, MB).astype(
        np.int32)
    lens = np.asarray([17, 5, 11], np.int32)
    sinks = rng.normal(0, 2, H).astype(np.float32)
    q = rng.normal(size=(R, 1, H, hd)).astype(np.float32)
    kw = dict(sliding_window=window)
    want = jpk.paged_attend_decode(
        *map(jnp.asarray, (q, kp, vp, bt, lens)), sinks=jnp.asarray(sinks),
        **kw)
    got = tpk.paged_attend_decode(*map(_t, (q, kp, vp, bt, lens)),
                                  sinks=_t(sinks), **kw)
    np.testing.assert_allclose(got.numpy(), want, **ATOL)
    T = 6
    qt, kt, vt = _qkv(rng, R, T, T, H, Hkv)
    plen = np.asarray([8, 0, 4], np.int32)
    qpos = (plen[:, None] + np.arange(T)).astype(np.int32)
    tail_valid = np.arange(T)[None, :] < np.asarray([[6], [3], [5]])
    args = (qt, kt, vt, kp, vp, bt[:, :2], plen, qpos, tail_valid)
    want = jpk.paged_attend_prefix(*map(jnp.asarray, args),
                                   sinks=jnp.asarray(sinks), **kw)
    got = tpk.paged_attend_prefix(*map(_t, args), sinks=_t(sinks), **kw)
    np.testing.assert_allclose(got.numpy(), want, **ATOL)


@pytest.fixture(scope="module")
def model_pair():
    jcfg, tcfg = cfgs(**GPT_OSS)
    jp, tp = trees(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


def test_dense_logits_match_jax(model_pair):
    jcfg, tcfg, jp, tp = model_pair
    model = ttf.Transformer(tcfg, tp)
    assert model.layers[0].sinks is not None and model.layers[0].window == 8
    rng = np.random.default_rng(3)
    B, S0 = 2, 20
    toks = rng.integers(0, 256, (B, S0)).astype(np.int32)
    lens = np.asarray([20, 13], np.int32)
    jlog, jcache = jit_prefill(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens),
                               jax_init_cache(jcfg, B, 48))
    with torch.inference_mode():
        cache = init_cache(tcfg, B, 48)
        tlog, cache = model.prefill(_t(toks).long(), _t(lens), cache)
        for b, n in enumerate(lens):
            np.testing.assert_allclose(tlog[b, :n].numpy(),
                                       np.asarray(jlog)[b, :n], **TOL)
        for _ in range(4):
            nxt = rng.integers(0, 256, (B, 1)).astype(np.int32)
            jlog, jcache = jit_decode_step(jp, jcfg, jnp.asarray(nxt), jcache)
            tlog, cache = model.decode_step(_t(nxt).long(), cache)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


def test_paged_logits_match_jax(model_pair):
    """A wave of two tails (one over a cached 8-token prefix), then decode
    steps over the pool, past the window of 8."""
    jcfg, tcfg, jp, tp = model_pair
    model = ttf.Transformer(tcfg, tp)
    rng = np.random.default_rng(4)
    bs, nb = 8, 32
    toks = rng.integers(0, 256, (2, 16)).astype(np.int32)
    tail_len = np.asarray([16, 11], np.int32)
    tail_blocks = np.asarray([[3, 4], [6, 7]], np.int32)
    prefix_blocks = np.asarray([[0, 0], [5, 0]], np.int32)
    prefix_len = np.asarray([0, 8], np.int32)
    jpool = jax_init_paged(jcfg, nb, bs)
    pool = init_paged_cache(tcfg, nb, bs)
    # the second row's prefix: block 5 written by a first wave
    pre = rng.integers(0, 256, (1, 8)).astype(np.int32)
    one = (np.asarray([8], np.int32), np.asarray([[5]], np.int32),
           np.zeros((1, 1), np.int32), np.zeros(1, np.int32))
    _, jpool = jit_paged_prefill_tail(jp, jcfg, jnp.asarray(pre),
                                      *map(jnp.asarray, one), jpool)
    with torch.inference_mode():
        model.paged_prefill_tail(_t(pre).long(), *map(_t, one), pool)
        args = (tail_len, tail_blocks, prefix_blocks, prefix_len)
        jl, jpool = jit_paged_prefill_tail(jp, jcfg, jnp.asarray(toks),
                                           *map(jnp.asarray, args), jpool)
        tl, pool = model.paged_prefill_tail(_t(toks).long(), *map(_t, args),
                                            pool)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        bt = np.asarray([[3, 4, 8], [5, 6, 7]], np.int32)
        cl = np.asarray([16, 19], np.int32)
        for _ in range(4):
            cur = rng.integers(0, 256, 2).astype(np.int32)
            jl, jpool = jit_paged_decode_step(
                jp, jcfg, jnp.asarray(cur), jpool, jnp.asarray(bt),
                jnp.asarray(cl))
            tl, pool = model.paged_decode_step(_t(cur).long(), pool, _t(bt),
                                               _t(cl))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            cl = cl + 1


def _prompts():
    rng = np.random.default_rng(7)
    a = rng.integers(1, 256, 4).tolist()
    return [(a * 5)[:19], rng.integers(1, 256, 13).tolist(),
            rng.integers(1, 256, 9).tolist(), rng.integers(1, 256, 17).tolist()]


def _drive(b, sp, **kw):
    b.DECODE_CHUNKS = (4,)
    reqs = [b.submit(p, max_new_tokens=10, sampling=sp.greedy(), seed=1)
            for p in _prompts()]
    for _ in range(400):
        b.step()
        if all(r.done.is_set() for r in reqs):
            break
    return [r.wait() for r in reqs]


_JAX_BATCHED: dict = {}


def _kernels_forbidden(monkeypatch):
    """Make every attention kernel entry point of the port raise."""
    from distributed_llm_inferencing_tpu_torch.ops import (
        attention, flash_attention, fused_decode, paged_kvcache)

    def forbidden(*a, **k):
        raise AssertionError("an attention kernel ran for a sinks model")
    for mod, names in ((attention, ("flash_attention", "flash_decode")),
                       (flash_attention, ("flash_attention",
                                          "flash_decode")),
                       (paged_kvcache, ("paged_flash_decode",)),
                       (fused_decode, ("fused_decode_step",))):
        for n in names:
            monkeypatch.setattr(mod, n, forbidden)


@pytest.mark.parametrize("mode", ["engine", "batcher", "spec_batcher"])
def test_serving_tokens_match_jax(model_pair, mode, monkeypatch):
    """Greedy tokens against the JAX engine (engine) and the JAX batcher
    (the batcher, and the speculative batcher, whose greedy tokens are the
    plain batcher's), with every attention kernel forbidden."""
    jcfg, tcfg, jp, tp = model_pair
    monkeypatch.setenv("DLI_FUSED_DECODE", "1")   # the gate must refuse
    if mode == "engine":
        prompts = _prompts()[:2]
        want = JaxEngine(jcfg, jp, max_seq=64).generate(
            prompts, max_new_tokens=10,
            sampling=JaxSamplingParams.greedy()).tokens
        _kernels_forbidden(monkeypatch)
        got = InferenceEngine(tcfg, tp, max_seq=64, device="cpu").generate(
            prompts, max_new_tokens=10,
            sampling=SamplingParams.greedy()).tokens
        assert got == want
        return
    if "jax" not in _JAX_BATCHED:
        monkeypatch.setenv("DLI_FUSED_DECODE", "0")
        _JAX_BATCHED["jax"] = _drive(JaxBatcher(jcfg, jp, **POOL),
                                     JaxSamplingParams)
        monkeypatch.setenv("DLI_FUSED_DECODE", "1")
    _kernels_forbidden(monkeypatch)
    kw = ({} if mode == "batcher" else
          dict(speculative="ngram", spec_gamma=3, spec_adaptive=False))
    b = ContinuousBatcher(tcfg, tp, device="cpu", **POOL, **kw)
    assert _drive(b, SamplingParams) == _JAX_BATCHED["jax"]
    if mode == "spec_batcher":
        assert b.stats()["spec_accepted_tokens"] > 0
    b.stop()
