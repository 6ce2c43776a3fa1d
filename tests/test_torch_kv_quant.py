"""The int8 KV cache of the port (``kv_quant="int8"``) against the JAX
package's, on the CPU in f32.

- ``quant_kv`` gives the JAX function's int8 levels and scales bit for
  bit (``torch.round`` and ``jnp.round`` both round half to even; the
  input holds exact halves), for f32 and bf16 input; ``dequant_kv`` its
  values.
- The int8 cache's logits within 1e-4 of the JAX forward's (the JAX
  test_kv_quant.py prefill tolerance), on the dense path (prefill, then
  decode over the dequantized cache) and on the paged path (admission
  waves with a cached prefix, then decode through the gather route),
  for tiny-llama and falcon-rw-1b's tiny variant (ALiBi); the cache's
  levels equal the JAX cache's.
- Greedy tokens: the port's engine equals the JAX engine and the port's
  batcher the JAX batcher, both with the int8 cache, for tiny-llama and
  the ALiBi family; the int8 decode launches no decode kernel (it takes
  the plain route: no ``flash_decode``, ``paged_flash_decode`` or
  ``fused_decode_step``, also with ``DLI_FUSED_DECODE=1``).
- tp=2 over gloo (two processes, the kv heads' scales cut with them)
  equals tp=1: tokens, and teacher-forced logits within 1e-4.
- The worker serves ``kv_quantize`` in both modes; the int8 cache holds
  about half a bf16 cache's bytes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_llm_inferencing_tpu.models.params import (
    init_params as jax_init_params)
from distributed_llm_inferencing_tpu.models.registry import (
    get_config as jax_config)
from distributed_llm_inferencing_tpu.ops import kvcache as jkv
from distributed_llm_inferencing_tpu.ops.sampling import (
    SamplingParams as JaxSamplingParams)
from distributed_llm_inferencing_tpu.runtime.batcher import (
    ContinuousBatcher as JaxBatcher)
from distributed_llm_inferencing_tpu.runtime.engine import (
    InferenceEngine as JaxEngine)
from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.models.transformer import (
    Transformer)
from distributed_llm_inferencing_tpu_torch.ops import attention as tatt
from distributed_llm_inferencing_tpu_torch.ops import fused_decode as tfd
from distributed_llm_inferencing_tpu_torch.ops import kvcache as tkv
from distributed_llm_inferencing_tpu_torch.ops import paged_kvcache as tpk
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.parallel.mesh import MeshSpec
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from distributed_llm_inferencing_tpu_torch.runtime.worker import WorkerAgent
from test_torch_families import (  # noqa: F401
    TOL, family_pair, one_torch_thread)
from test_torch_families_batcher import POOL, drive
from test_torch_families_paged import _close, _dense_logits, _paged_logits

PROMPTS = [[3, 17, 52, 9, 1, 30, 44], list(range(5, 45))]
FORCED = [[7, 11], [250, 0], [31, 64]]


def test_quant_kv_equals_jax_bitwise():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 4, 16)).astype(np.float32)
    x[0, 0, 0] = np.arange(16) - 7.5       # amax 8.5: exact .5 levels
    x[1, 1, 1] = np.arange(16) * 0.5 - 3.75
    x[2, 2, 2] = 0.0                       # the scale's 1e-8 floor
    for arr in (x, x.astype(ml_dtypes.bfloat16)):
        jq, js = jkv.quant_kv(jnp.asarray(arr))
        t = torch.from_numpy(x)
        if arr.dtype != np.float32:
            t = t.to(torch.bfloat16)
        tq, ts = tkv.quant_kv(t)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        assert np.array_equal(np.asarray(jq), tq.numpy())
        assert np.asarray(js).tobytes() == ts.numpy().tobytes()
        back = tkv.dequant_kv(tq, ts, torch.float32).numpy()
        assert back.tobytes() == np.asarray(
            jkv.dequant_kv(jq, js, jnp.float32)).tobytes()


def _llama_pair():
    """(JAX config, JAX params, numpy tree, port model): tiny-llama f32,
    int8 cache."""
    jcfg = jax_config("tiny-llama").replace(dtype="float32",
                                            attn_backend="xla",
                                            kv_quant="int8")
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    model = Transformer(tcfg, params_from_jax(tree, tcfg, "cpu"))
    return jcfg, jax.tree.map(jnp.asarray, tree), tree, model


PAIRS = {"tiny-llama": _llama_pair,
         "falcon-rw-1b": lambda: family_pair("falcon-rw-1b",
                                             kv_quant="int8")}


def _no_decode_kernels(monkeypatch):
    """The int8 route must reach no decode kernel's wrapper (on the CPU
    a wrapper runs its plain version and counts nothing, so the wrappers
    are replaced by ones that fail), with the fused route asked for."""
    monkeypatch.setenv("DLI_FUSED_DECODE", "1")

    def banned(*a, **k):
        raise AssertionError("an int8 cache reached a decode kernel")
    for mod, fn in ((tatt, "flash_decode"), (tpk, "paged_flash_decode"),
                    (tfd, "fused_decode_step")):
        monkeypatch.setattr(mod, fn, banned)


@pytest.mark.parametrize("name", list(PAIRS))
def test_int8_logits_match_jax_dense_and_paged(monkeypatch, name):
    _no_decode_kernels(monkeypatch)
    jcfg, jparams, _, model = PAIRS[name]()
    _close(_dense_logits(jcfg, jparams, model))
    _close(_paged_logits(jcfg, jparams, model))


def _tokens_pair(name):
    jcfg, jparams, tree, model = PAIRS[name]()
    tparams = params_from_jax(tree, model.cfg, "cpu")
    return jcfg, jparams, model.cfg, tparams


@pytest.mark.parametrize("name", list(PAIRS))
def test_int8_engine_and_batcher_tokens_match_jax(monkeypatch, name):
    _no_decode_kernels(monkeypatch)
    jcfg, jparams, tcfg, tparams = _tokens_pair(name)
    ref = JaxEngine(jcfg, jparams, max_seq=96).generate(
        PROMPTS, max_new_tokens=10,
        sampling=JaxSamplingParams.greedy()).tokens
    teng = InferenceEngine(tcfg, tparams, max_seq=96, device="cpu")
    assert teng._cache(1).quantized
    got = teng.generate(PROMPTS, max_new_tokens=10,
                        sampling=SamplingParams.greedy()).tokens
    assert got == ref and all(len(t) == 10 for t in ref)
    ref = drive(JaxBatcher(jcfg, jparams, **POOL), JaxSamplingParams)
    assert ref[1][3] == 16                              # the prefix hit
    tb = ContinuousBatcher(tcfg, tparams, device="cpu", **POOL)
    assert tb.paged.quantized and tb.paged.k.dtype == torch.int8
    assert drive(tb, SamplingParams) == ref


@pytest.fixture(scope="module")
def tp_engines():
    jcfg, _, tree, _ = _llama_pair()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp1 = InferenceEngine(tcfg, params_from_jax(tree, tcfg, "cpu"),
                          max_seq=96, device="cpu")
    tp2 = InferenceEngine(tcfg, params_from_jax(tree, tcfg, "cpu"),
                          mesh_spec=MeshSpec(tp=2), max_seq=96, device="cpu")
    yield tp1, tp2
    tp2.close()


def test_int8_tp2_equals_tp1(tp_engines):
    tp1, tp2 = tp_engines
    g = SamplingParams.greedy()
    a, b = (e.generate(PROMPTS, max_new_tokens=10, sampling=g).tokens
            for e in (tp1, tp2))
    assert a == b
    pre1, dec1 = tp1.teacher_forced(PROMPTS, FORCED)
    pre2, dec2 = tp2.teacher_forced(PROMPTS, FORCED)
    for i, p in enumerate(PROMPTS):
        np.testing.assert_allclose(pre2[i, :len(p)].numpy(),
                                   pre1[i, :len(p)].numpy(), **TOL)
    np.testing.assert_allclose(dec2.numpy(), dec1.numpy(), **TOL)
    # the leader's cache holds its half of the kv heads, scales with them
    cache = tp2._cache(1)
    assert cache.k.shape[3] == 2 and cache.k_scale.shape[3] == 2


@pytest.mark.parametrize("serving", ["engine", "batched"])
def test_worker_serves_kv_quantize(serving):
    agent = WorkerAgent(device="cpu")
    body = {"model_name": "tiny-llama", "allow_random_init": True,
            "dtype": "float32", "serving": serving, "max_seq": 64,
            "kv_blocks": 32, "kv_block_size": 8, "slots": 2,
            "kv_quantize": "int8"}
    try:
        assert agent.load_model(body)[0] == 200
        lm = agent.models["tiny-llama"]
        owner = lm.batcher or lm.engine
        prompt = [5, 9, 200, 3, 77, 18, 2]
        res = agent.inference({"model_name": "tiny-llama",
                               "prompt_tokens": prompt, "max_new_tokens": 6,
                               "sampling": {"do_sample": False}})
        assert res["status"] == "success", res
        if lm.batcher is not None:
            assert lm.batcher.paged.quantized
            want = lm.batcher.submit(prompt, max_new_tokens=6,
                                     sampling=SamplingParams.greedy())
            assert want.wait(60) == res["tokens"]
        else:
            cache = lm.engine._cache(1)
            full = tkv.init_cache(owner.cfg.replace(kv_quant=None), 1, 64,
                                  dtype="bfloat16")
            qbytes = sum(t.nbytes for t in (cache.k, cache.v, cache.k_scale,
                                            cache.v_scale))
            # int8 levels plus one f32 scale per head vector (hd 8 here)
            assert qbytes == (full.k.nbytes + full.v.nbytes) * (1 + 4 / 8) / 2
            want = InferenceEngine(owner.cfg, owner.params, max_seq=64,
                                   device="cpu").generate(
                [prompt], max_new_tokens=6,
                sampling=SamplingParams.greedy()).tokens[0]
            assert want == res["tokens"]
    finally:
        agent.shutdown()
