"""Quantized weights of the dense families against the JAX package, on the
same weights (CPU, f32 activations).

int8 and int4 weights of one learned-position family (gpt2), one ALiBi
family (bloom) and one parallel-residual family (pythia), each with
biased linears whose bias is added after the quantized product:

- logits within 1e-4 over the dense path (a right-padded prefill and 4
  decode steps) and the paged path (``test_torch_families_paged.py``'s
  script);
- greedy tokens of the port's engine and batcher equal to the JAX
  batcher's: one JAX batcher run per case (its tokens and cached prompt
  tokens, kept for the module) holds both.

``embed_quant="int8"`` with a tied head (gpt2, gemma's MQA row): the
head reads the int8 table with its row scale on the vocabulary columns,
logits within 1e-4 of the JAX package's ``unembed``.
"""

import functools

import pytest

from distributed_llm_inferencing_tpu.ops.sampling import (
    SamplingParams as JaxSamplingParams)
from distributed_llm_inferencing_tpu.runtime.batcher import (
    ContinuousBatcher as JaxBatcher)
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from test_torch_families import family_pair, one_torch_thread  # noqa: F401
from test_torch_families_batcher import POOL, drive, prompts
from test_torch_families_paged import _close, _dense_logits, _paged_logits

_QUANT = [(n, q) for n in ("tiny-gpt2", "bloom-7b1", "pythia-6.9b")
          for q in ("int8", "int4")]


@pytest.mark.parametrize("name,quant", _QUANT)
def test_quantized_families_match_jax(name, quant):
    jcfg, jparams, _, model = family_pair(name, quant=quant)
    lin = model.layers[0].q
    assert lin.form == quant and ("b" in lin.leaf()) == jcfg.attn_bias
    _close(_dense_logits(jcfg, jparams, model))
    _close(_paged_logits(jcfg, jparams, model, steps=3))


@pytest.mark.parametrize("name", ["tiny-gpt2", "gemma-2b"])
def test_embed_quant_tied_head_matches_jax(name):
    jcfg, jparams, tree, model = family_pair(name, embed_quant="int8")
    assert model.lm_head is None and model.embed.quantized
    assert set(tree["embed"]["tokens"]) == {"q8", "rscale"}
    _close(_dense_logits(jcfg, jparams, model))


@functools.lru_cache(maxsize=None)
def _served(name, quant):
    """(the JAX batcher's tokens and cached prompt tokens for
    ``prompts()``, the port's config, its params) of ``name``'s tiny
    variant with ``quant`` weights: one JAX run per case for the engine
    and the batcher checks."""
    jcfg, jparams, tree, model = family_pair(name, quant=quant)
    ref = drive(JaxBatcher(jcfg, jparams, **POOL), JaxSamplingParams)
    assert ref[1][3] == 16                              # the prefix hit
    return ref, model.cfg, params_from_jax(tree, model.cfg, "cpu")


@pytest.mark.parametrize("name,quant", _QUANT)
def test_quantized_engine_tokens_match_jax(name, quant):
    (ref, _), cfg, params = _served(name, quant)
    got = InferenceEngine(cfg, params, max_seq=POOL["max_seq"],
                          device="cpu").generate(
        prompts(), max_new_tokens=10, sampling=SamplingParams.greedy())
    assert got.tokens == ref


@pytest.mark.parametrize("name,quant", _QUANT)
def test_quantized_batcher_tokens_match_jax(monkeypatch, name, quant):
    monkeypatch.setenv("DLI_FUSED_DECODE", "0")
    ref, cfg, params = _served(name, quant)
    b = ContinuousBatcher(cfg, params, device="cpu", **POOL)
    assert drive(b, SamplingParams) == ref
