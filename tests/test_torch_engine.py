"""The port's InferenceEngine against the JAX package's, same weights.

Both sides run tiny-llama in float32 on the CPU; greedy decoding must
give the same tokens for prompts of different lengths (different prefill
buckets), alone and as one ragged batch.
"""

import jax
import numpy as np
import pytest
import torch

from distributed_llm_inferencing_tpu.models.params import (
    init_params as jax_init_params)
from distributed_llm_inferencing_tpu.models.registry import (
    get_config as jax_config)
from distributed_llm_inferencing_tpu.ops.sampling import (
    SamplingParams as JaxSamplingParams)
from distributed_llm_inferencing_tpu.runtime.engine import (
    InferenceEngine as JaxEngine)
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.models.registry import get_config
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine, _bucket)
from test_torch_families import one_torch_thread  # noqa: F401

PROMPTS = [[3, 17, 52, 9, 1, 30, 44], list(range(5, 45))]   # buckets 16, 64


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_config("tiny-llama").replace(dtype="float32")
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jeng = JaxEngine(jcfg, params, max_seq=96)
    tcfg = get_config("tiny-llama").replace(dtype="float32")
    teng = InferenceEngine(
        tcfg, params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu"),
        max_seq=96, device="cpu")
    return jeng, teng


@pytest.mark.parametrize("batch", [[0], [1], [0, 1]])
def test_greedy_tokens_match_jax_engine(engines, batch):
    jeng, teng = engines
    prompts = [PROMPTS[i] for i in batch]
    ref = jeng.generate(prompts, max_new_tokens=12,
                        sampling=JaxSamplingParams.greedy()).tokens
    res = teng.generate(prompts, max_new_tokens=12,
                        sampling=SamplingParams.greedy())
    assert res.tokens == ref
    assert res.steps == 12 and all(len(t) == 12 for t in res.tokens)
    assert res.prefill_ms > 0 and res.decode_ms > 0


def test_eos_path_matches_and_trims(engines):
    jeng, teng = engines
    greedy = teng.generate([PROMPTS[0]], max_new_tokens=12,
                           sampling=SamplingParams.greedy()).tokens[0]
    eos = greedy[4]
    res = teng.generate([PROMPTS[0]], max_new_tokens=12,
                        sampling=SamplingParams.greedy(), eos_token_id=eos)
    ref = jeng.generate([PROMPTS[0]], max_new_tokens=12,
                        sampling=JaxSamplingParams.greedy(),
                        eos_token_id=eos).tokens[0]
    assert res.tokens[0] == ref == greedy[:greedy.index(eos)]


def test_sampled_generation_is_seeded(engines):
    _, teng = engines
    a, b, c = (teng.generate([PROMPTS[1]], max_new_tokens=10, seed=s).tokens
               for s in (4, 4, 5))
    assert a == b and a != c


def test_guards(engines):
    _, teng = engines
    with pytest.raises(ValueError):
        teng.generate([[1] * 90], max_new_tokens=10)      # past max_seq
    with pytest.raises(ValueError):
        teng.generate([[]], max_new_tokens=2)
    assert _bucket(16) == 16 and _bucket(17) == 32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            InferenceEngine(get_config("tiny-llama"))    # cuda by default
