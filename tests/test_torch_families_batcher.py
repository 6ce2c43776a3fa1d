"""The port's ContinuousBatcher against the JAX package's, for every dense
family, on the same weights (CPU, f32).

Each family's tiny variant (``test_torch_families.py``) serves four
prompts through both batchers (4 slots over a 128-block pool of 8-token
blocks; the fourth prompt shares the first's first 16 tokens, a radix
prefix hit), 10 greedy tokens each: equal tokens, and equal cached
prompt tokens. The families the fused gate concerns (gpt2, whose biased
q keeps it off the fused route; gemma and falcon-7b, which take it) also
run on the port with ``DLI_FUSED_DECODE=1`` (the fused kernel's plain
version on the CPU) and must give the JAX batcher's tokens again. Both
batchers run one decode-chunk size, so the JAX side compiles few
programs.
"""

import numpy as np
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
from test_torch_families import (  # noqa: F401
    FAMILIES, family_pair, one_torch_thread)

CHUNKS = (4,)
POOL = dict(num_blocks=128, block_size=8, slots=4, max_seq=96, seed=0)
_FUSED = ("tiny-gpt2", "gemma-7b", "gemma-2b", "falcon-7b")


def prompts():
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, 4).tolist()
    out = [(base * 6)[:20], rng.integers(0, 256, 9).tolist(),
           rng.integers(0, 256, 13).tolist()]
    return out + [out[0][:16] + rng.integers(0, 256, 7).tolist()]


def drive(b, sampling, max_new=10, steps=300):
    """Every prompt through batcher ``b``: (tokens, cached prompt tokens)
    per request."""
    b.DECODE_CHUNKS = CHUNKS
    reqs = [b.submit(p, max_new_tokens=max_new, sampling=sampling.greedy(),
                     seed=50 + i) for i, p in enumerate(prompts())]
    for _ in range(steps):
        b.step()
        if all(r.done.is_set() for r in reqs):
            break
    return ([r.wait() for r in reqs],
            [r.cost["prefill_cached_tokens"] for r in reqs])


def batchers(name, **over):
    """(JAX batcher, a maker of port batchers) of ``name``'s tiny variant
    on one set of weights."""
    jcfg, jparams, tree, model = family_pair(name, **over)
    jb = JaxBatcher(jcfg, jparams, **POOL)
    return jb, lambda: ContinuousBatcher(
        model.cfg, params_from_jax(tree, model.cfg, "cpu"), device="cpu",
        **POOL)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_batcher_greedy_tokens_match_jax(monkeypatch, name):
    monkeypatch.setenv("DLI_FUSED_DECODE", "0")
    jb, port = batchers(name)
    ref = drive(jb, JaxSamplingParams)
    assert ref[1][3] == 16                              # the prefix hit
    assert drive(port(), SamplingParams) == ref
    if name in _FUSED:
        monkeypatch.setenv("DLI_FUSED_DECODE", "1")
        assert drive(port(), SamplingParams) == ref


def test_batcher_refuses_past_the_context_window():
    """tiny-gpt2's 128 learned positions cap both batchers' max_seq."""
    jcfg, jparams, tree, model = family_pair("tiny-gpt2")
    big = dict(POOL, max_seq=4096)
    jb = JaxBatcher(jcfg, jparams, **big)
    tb = ContinuousBatcher(model.cfg, params_from_jax(tree, model.cfg, "cpu"),
                           device="cpu", **big)
    assert jb.max_seq == tb.max_seq == 128
    for b, sp in ((jb, JaxSamplingParams), (tb, SamplingParams)):
        with pytest.raises(ValueError):
            b.submit([1] * 120, max_new_tokens=16, sampling=sp.greedy())
