"""Greedy tokens of checkpoints loaded by the port against the JAX
package's, on the CPU in f32: the first ten converter types of
``test_torch_convert.HF_TINY`` (the other ten are in
``test_torch_convert_tokens_b.py``).

Each type's tiny saved checkpoint is loaded by the JAX
``load_hf_model`` and by the port's, in f32. One JAX reference per type,
the JAX engine's greedy tokens for four prompts in one ragged batch (the
fourth sharing the first's first 16 tokens), holds both of the port's
serving modes: the port's engine on the same batch, and the port's
batcher serving the four prompts as separate requests, must give those
tokens, and the batcher's fourth request must find the shared 16 tokens
in its prefix cache. (The JAX batcher gives the JAX engine's tokens on
these prompts; one JAX program set per type instead of two.)
"""

import jax.numpy as jnp
import numpy as np
import pytest

from distributed_llm_inferencing_tpu.models import convert as jconvert
from distributed_llm_inferencing_tpu.ops.sampling import (
    SamplingParams as JaxSamplingParams)
from distributed_llm_inferencing_tpu.runtime.engine import (
    InferenceEngine as JaxEngine)
from distributed_llm_inferencing_tpu_torch.models import convert
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from test_torch_convert import TYPES, saved
from test_torch_families import one_torch_thread  # noqa: F401

GROUP = TYPES[:10]
POOL = dict(num_blocks=128, block_size=8, slots=4, max_seq=96, seed=0)


def loaded(mt):
    """(JAX config, JAX params, port config, port params) of ``mt``'s
    saved checkpoint, f32."""
    d = saved(mt)
    jcfg, jparams = jconvert.load_hf_model(d, dtype=jnp.float32)
    cfg, params = convert.load_hf_model(d, dtype="float32", device="cpu")
    return (jcfg.replace(dtype="float32"), jparams,
            cfg.replace(dtype="float32"), params)


def batch_prompts():
    rng = np.random.default_rng(5)
    out = [rng.integers(0, 128, 20).tolist(), rng.integers(0, 128, 9).tolist(),
           rng.integers(0, 128, 13).tolist()]
    return out + [out[0][:16] + rng.integers(0, 128, 7).tolist()]


def drive(b, sampling, max_new=8, steps=300, prompts=None):
    b.DECODE_CHUNKS = (4,)
    reqs = [b.submit(p, max_new_tokens=max_new, sampling=sampling.greedy(),
                     seed=50 + i)
            for i, p in enumerate(prompts or batch_prompts())]
    for _ in range(steps):
        b.step()
        if all(r.done.is_set() for r in reqs):
            break
    return ([r.wait() for r in reqs],
            [r.cost["prefill_cached_tokens"] for r in reqs])


def check_tokens(mt, monkeypatch, prompts=None):
    """``mt``'s engine and batcher tokens against the JAX engine's greedy
    tokens for ``prompts`` (default ``batch_prompts()``: three fresh
    prompts, the fourth sharing the first's first 16 tokens)."""
    monkeypatch.setenv("DLI_FUSED_DECODE", "0")
    jcfg, jparams, cfg, params = loaded(mt)
    prompts = prompts or batch_prompts()
    ref = JaxEngine(jcfg, jparams, max_seq=96).generate(
        prompts, max_new_tokens=8, sampling=JaxSamplingParams.greedy()).tokens
    got = InferenceEngine(cfg, params, max_seq=96, device="cpu").generate(
        prompts, max_new_tokens=8, sampling=SamplingParams.greedy()).tokens
    assert got == ref and all(len(t) == 8 for t in ref)
    assert drive(ContinuousBatcher(cfg, params, device="cpu", **POOL),
                 SamplingParams, prompts=prompts) == (ref, [0, 0, 0, 16])


@pytest.mark.parametrize("mt", GROUP)
def test_loaded_checkpoint_greedy_tokens_match_jax(mt, monkeypatch):
    check_tokens(mt, monkeypatch)
