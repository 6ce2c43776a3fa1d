"""The port's transformer against the JAX package's, on the same weights.

tiny-llama in f32: a right-padded prefill and 8 decode steps must give
logits within 1e-4 (f32 matmuls in a different summation order, 4
layers) and equal caches at the same tolerance.
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
from distributed_llm_inferencing_tpu.ops.kvcache import (
    init_cache as jax_init_cache)
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.models.registry import get_config
from distributed_llm_inferencing_tpu_torch.models.transformer import (
    Transformer)
from distributed_llm_inferencing_tpu_torch.ops.kvcache import init_cache
from test_torch_families import (  # noqa: F401
    jit_decode_step, jit_prefill, one_torch_thread)

TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(name="tiny-llama", **over):
    jcfg = jax_config(name).replace(dtype="float32", attn_backend="xla",
                                    **over)
    params = jax_init_params(jcfg, jax.random.PRNGKey(3))
    tcfg = get_config(name).replace(dtype="float32", **over)
    tp = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, params, Transformer(tcfg, tp)


def _caches_close(jc, tc):
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


@pytest.mark.parametrize("over", [{}, {"sliding_window": 6}])
def test_prefill_and_decode_logits_match(over):
    jcfg, jparams, model = _pair(**over)
    rng = np.random.default_rng(0)
    B, S0, max_seq = 2, 16, 48
    lens = np.asarray([11, 16], np.int32)
    toks = rng.integers(0, jcfg.vocab_size, size=(B, S0)).astype(np.int32)
    toks[0, 11:] = 0                                   # right padding

    jcache = jax_init_cache(jcfg, B, max_seq)
    jlog, jcache = jit_prefill(jparams, jcfg, jnp.asarray(toks),
                               jnp.asarray(lens), jcache)
    with torch.inference_mode():
        tcache = init_cache(model.cfg, B, max_seq, device="cpu")
        tlog, tcache = model.prefill(torch.from_numpy(toks).long(),
                                     torch.from_numpy(lens), tcache)
        for b, n in enumerate(lens):   # rows past a length are never read
            np.testing.assert_allclose(tlog[b, :n].numpy(),
                                       np.asarray(jlog)[b, :n], **TOL)
        _caches_close(jcache, tcache)
        nxt = rng.integers(0, jcfg.vocab_size, size=(8, B)).astype(np.int32)
        for t in range(8):                              # teacher-forced
            jlog, jcache = jit_decode_step(jparams, jcfg,
                                           jnp.asarray(nxt[t][:, None]),
                                           jcache)
            tlog, tcache = model.decode_step(
                torch.from_numpy(nxt[t][:, None]).long(), tcache)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       **TOL)
        _caches_close(jcache, tcache)


def test_gather_keeps_only_the_last_real_row():
    _, _, model = _pair()
    toks = torch.randint(0, 256, (2, 16), generator=torch.Generator()
                         .manual_seed(1))
    lens = torch.tensor([5, 16], dtype=torch.int32)
    with torch.inference_mode():
        full, _ = model.prefill(toks, lens, init_cache(model.cfg, 2, 32))
        last, _ = model.prefill(toks, lens, init_cache(model.cfg, 2, 32),
                                gather=(lens - 1).long())
    assert last.shape == (2, 1, model.cfg.vocab_size)
    torch.testing.assert_close(last[:, 0], full[[0, 1], [4, 15]],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("over", [
    {"kv_quant": "fp8"},
])
def test_configs_outside_the_llama_arm_raise(over):
    """Features outside every ported family (the llama arm's other
    switches — ALiBi, parallel residual, a tied head — are ported with
    the dense families and held in tests/test_torch_families*.py; the
    later families' switches — q/k norms, softcaps, sandwich norms, ...
    — in tests/test_torch_switches.py)."""
    cfg = get_config("tiny-llama").replace(dtype="float32", **over)
    with pytest.raises(NotImplementedError):
        Transformer(cfg, {})
