"""Latent attention (deepseek's MLA) in the port against the JAX package
(CPU, f32, tiny-deepseek: 8 heads of [rope 8 | nope 16], v 16, q_lora
32, kv_lora 16, one dense-prefix layer ahead of two MoE layers behind the
deepseek_v3 router with a shared expert; the JAX init bridged bit for
bit, its zero leaves drawn from a seeded normal).

After the JAX package's tests/test_mla_latent.py:

- the projections (``_mla_q``, ``_mla_kv_latent``, ``_mla_qkv``) within
  1e-5, with and without the q bottleneck;
- prefill and decode logits over the latent and the materialized cache
  within 1e-4 of the JAX package's in float, int8 and int4, and the
  latent decode equal to the materialized one within 2e-4 (the JAX
  test's bound);
- the dense cache's size: deepseek-proxy's latent cache 19.2x smaller,
  its v plane zero-width;
- engine greedy tokens equal to the JAX engine's on both caches
  (``DLI_MLA_LATENT``) in float, int8 and int4, with the same stored
  weight bytes;
- speculative verify over the latent cache equal to plain greedy;
- batcher greedy tokens equal to the JAX batcher's (the materialized
  paged pool), on a native and an int8 pool;
- the bridge's ``layers_dense`` tree on layers 0..k-1 and the native
  checkpoint, bitwise;
- a prompt restored from the host tier, on the padded pool, gives its
  cold tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inferencing_tpu.models import transformer as jtf
from distributed_llm_inferencing_tpu.models.params import (
    param_bytes as jax_param_bytes)
from distributed_llm_inferencing_tpu.models.registry import (
    get_config as jax_config)
from distributed_llm_inferencing_tpu.ops.kvcache import (
    init_cache as jax_init_cache)
from distributed_llm_inferencing_tpu.ops.sampling import (
    SamplingParams as JaxSamplingParams)
from distributed_llm_inferencing_tpu.runtime.batcher import (
    ContinuousBatcher as JaxBatcher)
from distributed_llm_inferencing_tpu.runtime.engine import (
    InferenceEngine as JaxEngine)
from distributed_llm_inferencing_tpu_torch.models import checkpoint
from distributed_llm_inferencing_tpu_torch.models import registry as treg
from distributed_llm_inferencing_tpu_torch.models import transformer as ttf
from distributed_llm_inferencing_tpu_torch.models.params import (
    param_bytes, params_from_jax)
from distributed_llm_inferencing_tpu_torch.ops.kvcache import init_cache
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from test_torch_families import (  # noqa: F401
    jit_decode_step, jit_prefill, one_torch_thread)
from test_torch_routers import cfgs, layer, trees

TOL = dict(rtol=1e-4, atol=1e-4)
FORMS = [None, "int8", "int4"]
IDS = ["float", "int8", "int4"]
POOL = dict(num_blocks=128, block_size=8, slots=4, max_seq=96, seed=0)


def _pair(q=None, **over):
    jcfg, tcfg = cfgs("tiny-deepseek", quant=q, **over)
    jp, tp = trees(jcfg, tcfg, q)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def float_pair():
    return _pair()


@pytest.mark.parametrize("q_lora", [32, None], ids=["q_lora", "q_direct"])
def test_projections_match_jax(q_lora):
    jcfg, tcfg, jp, tp = _pair(q_lora_rank=q_lora)
    model = ttf.Transformer(tcfg, tp)
    blk = model.layers[1]            # an MoE layer (the attention is alike)
    lp = layer(jp, 0)
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 7, 64)).astype(np.float32)
    pos = np.tile(np.arange(3, 10, dtype=np.int32), (2, 1))
    jh, th = jnp.asarray(h), torch.from_numpy(h)
    cs = model._cos_sin(torch.from_numpy(pos).long())
    np.testing.assert_allclose(blk._mla_q(th, cs).detach().numpy(),
                               jtf._mla_q(jh, lp, jcfg, jnp.asarray(pos)),
                               rtol=1e-5, atol=1e-5)
    k_rot, c = blk._mla_kv_latent(th, cs)
    jk_rot, jc = jtf._mla_kv_latent(jh, lp, jcfg, jnp.asarray(pos))
    np.testing.assert_allclose(k_rot.detach().numpy(), jk_rot,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c.detach().numpy(), jc, rtol=1e-5, atol=1e-5)
    for got, want in zip(blk._mla_qkv(th, cs),
                         jtf._mla_qkv(jh, lp, jcfg, jnp.asarray(pos))):
        np.testing.assert_allclose(got.detach().numpy(), want,
                                   rtol=1e-5, atol=1e-5)


def _logits(model, cfg, toks, lens, steps):
    """Prefill then ``steps`` decode steps of the port; stacked logits."""
    cache = init_cache(cfg, toks.shape[0], 32)
    with torch.inference_mode():
        lg, cache = model.prefill(torch.from_numpy(toks).long(),
                                  torch.from_numpy(lens.copy()), cache)
        out = [lg[np.arange(len(lens)), lens - 1].numpy()]
        for t in steps:
            lg, cache = model.decode_step(torch.from_numpy(t).long(), cache)
            out.append(lg[:, 0].numpy())
    return np.stack(out)


def _jax_logits(jp, jcfg, toks, lens, steps):
    cache = jax_init_cache(jcfg, toks.shape[0], 32)
    lg, cache = jit_prefill(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens),
                            cache)
    out = [np.asarray(lg)[np.arange(len(lens)), lens - 1]]
    for t in steps:
        lg, cache = jit_decode_step(jp, jcfg, jnp.asarray(t), cache)
        out.append(np.asarray(lg)[:, 0])
    return np.stack(out)


@pytest.mark.parametrize("q", FORMS, ids=IDS)
def test_logits_match_jax_on_both_caches(q):
    jcfg, tcfg, jp, tp = _pair(q)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, (2, 9)).astype(np.int32)
    lens = np.asarray([9, 6], np.int32)
    steps = [rng.integers(0, 256, (2, 1)).astype(np.int32)
             for _ in range(4)]
    out = {}
    for latent in (False, True):
        jc, tc = (c.replace(mla_latent_cache=latent) for c in (jcfg, tcfg))
        got = _logits(ttf.Transformer(tc, tp), tc, toks, lens, steps)
        np.testing.assert_allclose(
            got, _jax_logits(jp, jc, toks, lens, steps), **TOL)
        out[latent] = got
    np.testing.assert_allclose(out[True], out[False], rtol=2e-4, atol=2e-4)


def test_latent_cache_is_smaller_by_the_claimed_ratio():
    cfg = treg.get_config("deepseek-proxy").replace(dtype="float32")
    lat = cfg.replace(mla_latent_cache=True)
    assert (lat.cache_kv_heads, lat.cache_head_dim, lat.cache_v_head_dim) \
        == (1, 160, 0)
    ck, cd = (init_cache(c, 1, 64, device="cpu") for c in (lat, cfg))
    assert tuple(ck.k.shape) == (12, 1, 64, 1, 160) and ck.v.numel() == 0
    assert tuple(cd.v.shape) == (12, 1, 64, 16, 96)
    ratio = (cd.k.numel() + cd.v.numel()) / (ck.k.numel() + ck.v.numel())
    assert ratio == pytest.approx(19.2)


def _engine_prompts(q):
    """Float: 20 and 13 tokens (a prefill past 32 positions: capacity
    dispatch); quantized: two prompts of at most 16 tokens, whose prefill
    the JAX package keeps dense (its capacity arm fails on quantized
    experts, ROADMAP Queue C)."""
    rng = np.random.default_rng(7)
    lens = (20, 13) if q is None else (11, 7)
    return [rng.integers(0, 256, n).tolist() for n in lens]


@pytest.mark.parametrize("q", FORMS, ids=IDS)
@pytest.mark.parametrize("latent", ["1", "0"], ids=["latent", "materialized"])
def test_engine_tokens_match_jax(q, latent, monkeypatch):
    monkeypatch.setenv("DLI_MLA_LATENT", latent)
    jcfg, tcfg, jp, tp = _pair(q)
    prompts = _engine_prompts(q)
    je = JaxEngine(jcfg, jp, max_seq=64)
    te = InferenceEngine(tcfg, tp, max_seq=64, device="cpu")
    assert je.cfg.mla_latent_cache == te.cfg.mla_latent_cache == \
        (latent == "1")
    want = je.generate(prompts, max_new_tokens=6,
                       sampling=JaxSamplingParams.greedy()).tokens
    got = te.generate(prompts, max_new_tokens=6,
                      sampling=SamplingParams.greedy()).tokens
    assert got == want and all(len(t) == 6 for t in want)
    assert param_bytes(te.params) == jax_param_bytes(je.params)


def test_latent_speculative_verify_matches_plain_greedy(float_pair):
    _, tcfg, _, tp = float_pair
    rng = np.random.default_rng(2)
    piece = rng.integers(0, 256, 4).tolist()
    prompt = (piece * 5)[:18]
    eng = InferenceEngine(tcfg, tp, max_seq=64, device="cpu")
    assert eng.cfg.mla_latent_cache
    plain = eng.generate([prompt], max_new_tokens=12,
                         sampling=SamplingParams.greedy()).tokens[0]
    spec = eng.generate([prompt], max_new_tokens=12,
                        sampling=SamplingParams.greedy(),
                        speculative="ngram", spec_gamma=3).tokens[0]
    assert spec == plain


def _drive(b, sp, prompts):
    b.DECODE_CHUNKS = (4,)
    reqs = [b.submit(p, max_new_tokens=8, sampling=sp.greedy(), seed=1)
            for p in prompts]
    for _ in range(300):
        b.step()
        if all(r.done.is_set() for r in reqs):
            break
    return [r.wait() for r in reqs]


@pytest.mark.parametrize("kv", [None, "int8"], ids=["native", "int8_pool"])
def test_batcher_tokens_match_jax(float_pair, kv, monkeypatch):
    monkeypatch.setenv("DLI_FUSED_DECODE", "0")
    jcfg, tcfg, jp, tp = float_pair
    jcfg, tcfg = (c.replace(kv_quant=kv) for c in (jcfg, tcfg))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, n).tolist() for n in (20, 13, 9, 17)]
    want = _drive(JaxBatcher(jcfg, jp, **POOL), JaxSamplingParams, prompts)
    b = ContinuousBatcher(tcfg, tp, device="cpu", **POOL)
    assert not b.cfg.mla_latent_cache
    assert tuple(b.paged.k.shape[-2:]) == (8, 24)   # per head, padded v
    assert _drive(b, SamplingParams, prompts) == want


def test_bridge_and_native_checkpoint_bitwise(float_pair, tmp_path):
    jcfg, tcfg, jp, tp = float_pair
    jd, jm = layer(jp, 0, "layers_dense"), layer(jp, 1)
    for name, leaf in (("layers.0.gate.w", jd["gate"]["w"]),
                       ("layers.0.kv_b_k.w", jd["kv_b_k"]["w"]),
                       ("layers.2.experts.up.w", jm["experts"]["up"]["w"]),
                       ("layers.2.router.bias", jm["router"]["bias"]),
                       ("layers.1.shared_down.w", layer(jp, 0)[
                           "shared_down"]["w"])):
        assert torch.equal(tp[name], torch.from_numpy(np.array(leaf))), name
    assert tp["layers.0.gate.w"].shape == (64, 48)   # dense_intermediate
    assert "layers.0.router.w" not in tp
    checkpoint.save_checkpoint(str(tmp_path), tcfg, tp)
    cfg, back = checkpoint.load_checkpoint(str(tmp_path), device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    assert set(back) == set(tp)
    for k, t in tp.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k


def _serve(b, prompt):
    r = b.submit(prompt, max_new_tokens=6, sampling=SamplingParams.greedy(),
                 seed=3)
    for _ in range(200):
        b.step()
        if r.done.is_set():
            break
    return r.wait(), r.cost


def test_tier_restore_equals_cold_run(float_pair):
    """The host tier carries the padded pool's blocks unchanged: a
    prompt whose blocks were evicted and restored gives its cold tokens."""
    _, tcfg, _, tp = float_pair
    b = ContinuousBatcher(tcfg, tp, num_blocks=12, block_size=8, slots=2,
                          max_seq=96, device="cpu", kv_host_mb=8)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 256, 41).tolist()
    cold, _ = _serve(b, prompt)
    for _ in range(3):   # three 40-token prompts evict its blocks
        _serve(b, rng.integers(0, 256, 40).tolist())
    toks, cost = _serve(b, prompt)
    assert toks == cold
    assert cost["prefill_cached_tokens"] == 40
    assert cost["arena_restored_bytes"] > 0
