"""The dense model families on the paged path, against the JAX package on
the same weights (CPU, f32).

The tiny variants and their shared weights come from
``test_torch_families.py`` (``family_pair``). Held here, logits within
1e-4:

- the paged path of every family: a 16-token prompt, then a wave of two
  tails, one reusing that prompt's blocks as its cached prefix, then 6
  teacher-forced ``paged_decode_step``s — against the JAX package's
  ``paged_prefill_tail`` / ``paged_decode_step``; with
  ``DLI_FUSED_DECODE=1`` as well for the families the fused gate
  concerns (gemma and falcon-7b take the fused route; gpt2's biased q
  does not);
- the ALiBi families decode through the gather formulation and never
  reach the paged kernel's wrapper; the others do.

``_paged_logits`` and ``_dense_logits`` are shared with
``test_torch_families_quant.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inferencing_tpu.ops.kvcache import (
    init_cache as jax_init_cache)
from distributed_llm_inferencing_tpu.ops.paged_kvcache import (
    init_paged_cache as jax_init_paged)
from distributed_llm_inferencing_tpu_torch.ops import paged_kvcache as tpk
from distributed_llm_inferencing_tpu_torch.ops.kvcache import init_cache
from test_torch_families import (  # noqa: F401
    FAMILIES, TOL, family_pair, jit_decode_step, jit_paged_decode_step,
    jit_paged_prefill_tail, jit_prefill, one_torch_thread)

_FUSED = ["tiny-gpt2", "gemma-7b", "gemma-2b", "falcon-7b"]


def _i32(a):
    return np.asarray(a, np.int32)


def _paged_logits(jcfg, jparams, model, steps=6):
    """The JAX and the port's logits over one paged script; returns the
    list of (jax, port) logit pairs."""
    bs, rng = 8, np.random.default_rng(0)
    jpool = jax_init_paged(jcfg, 16, bs)
    tpool = tpk.init_paged_cache(model.cfg, 16, bs, device="cpu")
    prompt = rng.integers(0, jcfg.vocab_size, (1, 16))
    tails = rng.integers(0, jcfg.vocab_size, (2, 24))
    waves = [(prompt, _i32([16]), _i32([[1, 2]]), _i32([[0, 0]]), _i32([0])),
             (tails, _i32([10, 19]), _i32([[3, 4, 5], [6, 7, 8]]),
              _i32([[1, 2], [0, 0]]), _i32([16, 0]))]
    out = []
    with torch.inference_mode():
        for toks, *rest in waves:
            jl, jpool = jit_paged_prefill_tail(
                jparams, jcfg, jnp.asarray(toks, jnp.int32),
                *map(jnp.asarray, rest), jpool)
            tl, _ = model.paged_prefill_tail(
                torch.from_numpy(toks).long(), *map(torch.from_numpy, rest),
                tpool)
            out.append((jl, tl))
        bt, cl = _i32([[1, 2, 3, 4], [6, 7, 8, 9]]), _i32([26, 19])
        for _ in range(steps):
            nxt = rng.integers(0, jcfg.vocab_size, 2).astype(np.int32)
            jl, jpool = jit_paged_decode_step(
                jparams, jcfg, jnp.asarray(nxt), jpool, jnp.asarray(bt),
                jnp.asarray(cl))
            tl, _ = model.paged_decode_step(
                torch.from_numpy(nxt).long(), tpool, torch.from_numpy(bt),
                torch.from_numpy(cl))
            out.append((jl, tl))
            cl = cl + 1
    return out


def _dense_logits(jcfg, jparams, model, steps=4):
    """The JAX and the port's logits over a right-padded prefill (the
    last real row of each sequence) and ``steps`` decode steps."""
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    lens = _i32([9, 16])
    jl, jc = jit_prefill(jparams, jcfg, jnp.asarray(toks), jnp.asarray(lens),
                         jax_init_cache(jcfg, 2, 32))
    out = []
    with torch.inference_mode():
        tl, tc = model.prefill(torch.from_numpy(toks).long(),
                               torch.from_numpy(lens),
                               init_cache(model.cfg, 2, 32, device="cpu"))
        out.append((np.asarray(jl)[:, 8], tl[:, 8]))
        for _ in range(steps):
            nxt = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
            jl, jc = jit_decode_step(jparams, jcfg, jnp.asarray(nxt), jc)
            tl, tc = model.decode_step(torch.from_numpy(nxt).long(), tc)
            out.append((jl, tl))
    return out


def _close(pairs):
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("fused,name", [(False, n) for n in FAMILIES]
                         + [(True, n) for n in _FUSED])
def test_paged_logits_match_jax(monkeypatch, name, fused):
    monkeypatch.setenv("DLI_FUSED_DECODE", "1" if fused else "0")
    jcfg, jparams, _, model = family_pair(name)
    _close(_paged_logits(jcfg, jparams, model))


@pytest.mark.parametrize("name,alibi", [("bloom-7b1", True),
                                        ("falcon-rw-1b", True),
                                        ("mpt-7b", True),
                                        ("phi-2", False)])
def test_alibi_decodes_through_the_gather_route(monkeypatch, name, alibi):
    """The ALiBi families' paged decode takes ``gather_attend_decode`` (as
    the JAX package keeps ALiBi off its paged kernel) and never calls the
    paged kernel's wrapper; the others never take the gather route."""
    calls = {"kernel": 0, "gather": 0}

    def wrap(fn, key):
        def f(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return f
    monkeypatch.setattr(tpk, "paged_flash_decode",
                        wrap(tpk.paged_flash_decode, "kernel"))
    monkeypatch.setattr(tpk, "gather_attend_decode",
                        wrap(tpk.gather_attend_decode, "gather"))
    jcfg, jparams, _, model = family_pair(name)
    _close(_paged_logits(jcfg, jparams, model, steps=2))
    L = jcfg.num_layers
    assert calls == ({"kernel": 0, "gather": 2 * L} if alibi
                     else {"kernel": 2 * L, "gather": 0})
