"""The port's plain ops against the JAX package's, on the same inputs.

Inputs come from numpy with a seed and go through both functions; f32
everywhere, so the tolerances (1e-6 norms, 1e-5 rope/attention) only
cover summation order and transcendental ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inferencing_tpu.ops import attention as jatt
from distributed_llm_inferencing_tpu.ops import kvcache as jkv
from distributed_llm_inferencing_tpu.ops import norms as jnorms
from distributed_llm_inferencing_tpu.ops import rope as jrope
from distributed_llm_inferencing_tpu_torch.ops import attention as tatt
from distributed_llm_inferencing_tpu_torch.ops import kvcache as tkv
from distributed_llm_inferencing_tpu_torch.ops import norms as tnorms
from distributed_llm_inferencing_tpu_torch.ops import rope as trope
from test_torch_families import one_torch_thread  # noqa: F401


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _close(t, j, tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(2, 5, 64), (1, 3, 4096)])
def test_rms_norm_matches(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    s = rng.normal(size=shape[-1:]).astype(np.float32)
    (jx, tx), (js, ts) = _pair(x), _pair(s)
    _close(tnorms.rms_norm(tx, ts, 1e-5), jnorms.rms_norm(jx, js, 1e-5), 1e-6)


def test_layer_norm_matches():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 48)).astype(np.float32)
    s, b = (rng.normal(size=(48,)).astype(np.float32) for _ in range(2))
    (jx, tx), (js, ts), (jb, tb) = _pair(x), _pair(s), _pair(b)
    _close(tnorms.layer_norm(tx, ts, tb), jnorms.layer_norm(jx, js, jb), 1e-6)


@pytest.mark.parametrize("hd,theta", [(8, 10000.0), (128, 500000.0)])
def test_apply_rope_matches(hd, theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 4, hd)).astype(np.float32)
    pos = rng.integers(0, 120, size=(2, 9)).astype(np.int32)
    (jx, tx), (jp, tp) = _pair(x), _pair(pos)
    _close(trope.apply_rope(tx, tp, theta), jrope.apply_rope(jx, jp, theta),
           1e-5)
    cs = trope.rope_cos_sin(tp, hd, theta)
    _close(trope.apply_rope(tx, None, theta, cos_sin=cs),
           jrope.apply_rope(jx, jp, theta), 1e-5)


def test_apply_rope_refuses_partial_and_interleaved():
    """Partial and interleaved rotary are ported (held against the JAX
    package in tests/test_torch_families.py); what stays refused is a
    rotated width that is odd or empty, which turns no whole pair (the
    JAX function fails on it too)."""
    x = torch.zeros(1, 2, 1, 8)
    pos = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        trope.apply_rope(x, pos, 1e4, pct=0.375)          # 3 of 8 dims
    with pytest.raises(ValueError):
        trope.apply_rope(x, pos, 1e4, pct=0.125, interleaved=True)
    with pytest.raises(ValueError):
        trope.apply_rope(x, pos, 1e4, pct=0.0)


@pytest.mark.parametrize("H,Hkv,window,alibi,softcap", [
    (8, 4, None, False, None),    # GQA
    (4, 4, None, False, None),    # MHA
    (8, 1, None, False, None),    # MQA
    (8, 2, 5, False, None),       # window
    (4, 4, None, True, None),     # ALiBi
    (8, 2, None, False, 0.7),     # softcap (gemma2)
    (8, 1, 5, False, 0.5),        # softcap and window, MQA
    (4, 4, None, True, 0.7),      # softcap before ALiBi
])
def test_attend_matches(H, Hkv, window, alibi, softcap):
    rng = np.random.default_rng(3)
    B, Sq, Skv, hd = 2, 6, 20, 16
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, hd)).astype(np.float32)
    qpos = np.stack([np.arange(8, 8 + Sq), np.arange(3, 3 + Sq)]).astype(
        np.int32)
    kvpos = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    valid = kvpos < np.asarray([[15], [9]])
    args = [_pair(a) for a in (q, k, v, qpos, kvpos, valid)]
    jargs, targs = [a[0] for a in args], [a[1] for a in args]
    jsl = jatt.alibi_slopes(H) if alibi else None
    tsl = tatt.alibi_slopes(H) if alibi else None
    if alibi:
        np.testing.assert_array_equal(tsl.numpy(), np.asarray(jsl))
    out = tatt.attend(*targs, sliding_window=window, alibi=tsl,
                      softcap=softcap)
    ref = jatt.attend(*jargs, sliding_window=window, alibi=jsl,
                      softcap=softcap)
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("starts", [[0, 3], [5, 12]])
def test_write_block_matches_in_place(starts):
    rng = np.random.default_rng(4)
    cache = rng.normal(size=(2, 16, 2, 8)).astype(np.float32)
    new = rng.normal(size=(2, 4, 2, 8)).astype(np.float32)
    st = np.asarray(starts, np.int32)
    ref = jkv.write_block(jnp.asarray(cache), jnp.asarray(new),
                          jnp.asarray(st))
    tc = torch.from_numpy(cache.copy())
    ptr = tc.data_ptr()
    out = tkv.write_block(tc, torch.from_numpy(new), torch.from_numpy(st))
    assert out.data_ptr() == ptr          # in place: the same buffer
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
