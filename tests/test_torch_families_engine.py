"""The port's InferenceEngine against the JAX package's, for every dense
family, on the same weights (CPU, f32).

Each family's tiny variant (``test_torch_families.py``) is served by
both engines; greedy decoding of one ragged batch (prompts of 7 and 40
tokens, prefill buckets 16 and 64) must give the same tokens. A request
past a learned-position family's context window is refused by both, as
the JAX engine refuses it.
"""

import jax
import numpy as np
import pytest

from distributed_llm_inferencing_tpu.ops.sampling import (
    SamplingParams as JaxSamplingParams)
from distributed_llm_inferencing_tpu.runtime.engine import (
    InferenceEngine as JaxEngine)
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from test_torch_families import (  # noqa: F401
    FAMILIES, family_pair, one_torch_thread)

PROMPTS = [[3, 17, 52, 9, 1, 30, 44], list(range(5, 45))]


def engines(name, **over):
    """(JAX engine, port engine) of ``name``'s tiny variant on one set of
    weights."""
    jcfg, jparams, tree, model = family_pair(name, **over)
    jeng = JaxEngine(jcfg, jparams, max_seq=96)
    teng = InferenceEngine(model.cfg, params_from_jax(tree, model.cfg, "cpu"),
                           max_seq=96, device="cpu")
    return jeng, teng


def greedy_tokens(eng, sampling, prompts=PROMPTS, new=10):
    return eng.generate(prompts, max_new_tokens=new,
                        sampling=sampling.greedy()).tokens


@pytest.mark.parametrize("name", list(FAMILIES))
def test_engine_greedy_tokens_match_jax(name):
    jeng, teng = engines(name)
    ref = greedy_tokens(jeng, JaxSamplingParams)
    assert greedy_tokens(teng, SamplingParams) == ref
    assert all(len(t) == 10 for t in ref)


def test_context_window_refused_as_the_jax_engine_refuses():
    """tiny-gpt2's 128 learned positions: 120 prompt tokens + 16 new are
    past them on both sides, at every max_seq asked for."""
    jcfg, jparams, tree, model = family_pair("tiny-gpt2")
    teng = InferenceEngine(model.cfg, params_from_jax(tree, model.cfg, "cpu"),
                           max_seq=4096, device="cpu")
    jeng = JaxEngine(jcfg, jparams, max_seq=4096)
    assert teng.max_seq == jeng.max_seq == 128
    for eng, sp in ((jeng, JaxSamplingParams), (teng, SamplingParams)):
        with pytest.raises(ValueError):
            eng.generate([[1] * 120], max_new_tokens=16, sampling=sp.greedy())
    assert len(greedy_tokens(teng, SamplingParams, [[1] * 120], 8)[0]) == 8
