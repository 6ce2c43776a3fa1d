"""Greedy tokens of the experts and latent-attention checkpoints loaded by
the port against the JAX package's, on the CPU in f32: the six converter
types of ``test_torch_convert.EXPERT_TYPES`` (glm4_moe, ernie4_5_moe,
hunyuan_v1_moe, dbrx with a ``clip_qkv`` that bites, gpt_oss,
deepseek_v3), in float weights here, int8 and int4 in
``test_torch_convert_tokens_e.py``.

Each type's tiny saved checkpoint is loaded by the JAX ``load_hf_model``
and by the port's. The port's engine gives the JAX engine's tokens and
the port's batcher the JAX batcher's (the two JAX references differ for
experts: capacity dispatch sees other shapes in an engine batch than in
the batcher's admission waves). In float the four prompts of
``test_torch_convert_tokens_a.batch_prompts`` (a prefill past 32
positions: capacity dispatch); quantized, prompts of at most 8 tokens,
whose prefills the JAX package keeps dense (its capacity arm fails on
quantized experts, ROADMAP Queue C).
"""

import numpy as np
import pytest

from distributed_llm_inferencing_tpu.ops.sampling import (
    SamplingParams as JaxSamplingParams)
from distributed_llm_inferencing_tpu.runtime.batcher import (
    ContinuousBatcher as JaxBatcher)
from distributed_llm_inferencing_tpu.runtime.engine import (
    InferenceEngine as JaxEngine)
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from test_torch_convert import EXPERT_TYPES
from test_torch_convert_tokens_a import POOL, batch_prompts, drive, loaded
from test_torch_families import one_torch_thread  # noqa: F401


def short_prompts():
    rng = np.random.default_rng(6)
    return [rng.integers(0, 128, n).tolist() for n in (8, 5, 7, 6)]


def check_expert_tokens(mt, monkeypatch, q=None):
    """``mt``'s port engine tokens against the JAX engine's and its port
    batcher tokens against the JAX batcher's, in weight form ``q``."""
    monkeypatch.setenv("DLI_FUSED_DECODE", "0")
    jcfg, jparams, cfg, params = loaded(mt)
    jcfg, cfg = jcfg.replace(quant=q), cfg.replace(quant=q)
    prompts = batch_prompts() if q is None else short_prompts()
    engine = prompts if q is None else prompts[:2]
    want = JaxEngine(jcfg, jparams, max_seq=96).generate(
        engine, max_new_tokens=8, sampling=JaxSamplingParams.greedy()).tokens
    got = InferenceEngine(cfg, dict(params), max_seq=96,
                          device="cpu").generate(
        engine, max_new_tokens=8, sampling=SamplingParams.greedy()).tokens
    assert got == want and all(len(t) == 8 for t in want)
    want, _ = drive(JaxBatcher(jcfg, jparams, **POOL), JaxSamplingParams,
                    prompts=prompts)
    got, _ = drive(ContinuousBatcher(cfg, dict(params), device="cpu",
                                     **POOL), SamplingParams,
                   prompts=prompts)
    assert got == want


@pytest.mark.parametrize("mt", list(EXPERT_TYPES))
def test_expert_checkpoint_tokens_match_jax(mt, monkeypatch):
    check_expert_tokens(mt, monkeypatch)
