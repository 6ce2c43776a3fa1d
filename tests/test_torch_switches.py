"""The dense model switches of the later families against the JAX
package's forward, at the model level, on the CPU in f32.

Each case is one switch (or one pair that only means something together)
turned on in a tiny registry variant of ``test_torch_families.py``
(``family_pair``: the JAX init with every bias and norm moved by a
seeded draw, bridged bit for bit), and each holds the logits within 1e-4
of the JAX package on both paths: the dense prefill and decode steps
(``_dense_logits``, from ``test_torch_families_paged.py``) and the paged
script of that file's ``_paged_logits`` with its two prefill waves cut
to one shape (``_paged_logits_one_shape``: the JAX side compiles one
tail-prefill program per case, not two). The caps are small enough to
bite at the tiny model's score and logit sizes, the windows shorter than
the prompts. Held beside them: each block holds its
layer's window and rope switch, the bridge refuses per-layer leaves that
disagree with the config, tp admits every switch, and the features
still outside the port stay refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inferencing_tpu.ops.paged_kvcache import (
    init_paged_cache as jax_init_paged)

from distributed_llm_inferencing_tpu_torch.models import registry as treg
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.models.transformer import (
    Transformer)
from distributed_llm_inferencing_tpu_torch.ops import norms
from distributed_llm_inferencing_tpu_torch.ops import paged_kvcache as tpk
from distributed_llm_inferencing_tpu_torch.parallel.mesh import (
    MeshSpec, validate_spec)
from test_torch_families import (  # noqa: F401
    family_pair, jit_paged_decode_step, jit_paged_prefill_tail,
    one_torch_thread)
from test_torch_families_paged import _close, _dense_logits, _i32

# case -> (tiny registry row, switches)
SWITCHES = {
    "qk_norm-rms_head": ("qwen2-7b", {"qk_norm": "rms_head"}),
    "qk_norm-ln_head": ("pythia-6.9b", {"qk_norm": "ln_head"}),
    "qk_norm-rms_full": ("qwen2-7b", {"qk_norm": "rms_full"}),
    "qk_norm-after_rope": ("qwen2-7b", {"qk_norm": "rms_head",
                                        "qk_norm_after_rope": True}),
    "attn_windows": ("qwen2-7b", {"attn_windows": (None, 5)}),
    # on gemma-2b's single kv head, with a window
    "attn_softcap": ("gemma-2b", {"attn_softcap": 0.05,
                                  "sliding_window": 6}),
    "logit_softcap": ("gemma-7b", {"logit_softcap": 0.1}),
    "post_block_norms": ("gemma-7b", {"post_block_norms": True}),
    "sublayer_postnorm_only": ("qwen2-7b", {"sublayer_postnorm_only": True}),
    # cohere's pair: a logit scale on the parallel residual, both branches
    # scaled
    "logit_scale": ("pythia-6.9b", {"logit_scale": 3.0,
                                    "residual_scale": 0.4}),
    "residual_scale": ("qwen2-7b", {"residual_scale": 0.4}),
    "rope_layers": ("qwen2-7b", {"rope_layers": (0, 1)}),
    "relu2": ("pythia-6.9b", {"activation": "relu2"}),
}


def _paged_logits_one_shape(jcfg, jparams, model, steps=4):
    """``_paged_logits``' script, its first wave padded to the second's
    shape (two rows of 24 tokens, tables of 3, prefixes of 2): a 16-token
    prompt into blocks 1, 2 (its padding into the dummy block) beside a
    padding row, then two tails, one reusing that prompt's blocks as its
    cached prefix, then ``steps`` teacher-forced decode steps. Returns
    the (jax, port) logit pairs."""
    bs, rng = 8, np.random.default_rng(0)
    jpool = jax_init_paged(jcfg, 16, bs)
    tpool = tpk.init_paged_cache(model.cfg, 16, bs, device="cpu")
    first = np.zeros((2, 24), np.int64)
    first[0, :16] = rng.integers(0, jcfg.vocab_size, 16)
    tails = rng.integers(0, jcfg.vocab_size, (2, 24))
    waves = [(first, _i32([16, 1]), _i32([[1, 2, 0], [0, 0, 0]]),
              _i32([[0, 0], [0, 0]]), _i32([0, 0])),
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


@pytest.mark.parametrize("case", list(SWITCHES))
def test_switch_logits_match_jax_dense_and_paged(case, monkeypatch):
    monkeypatch.setenv("DLI_FUSED_DECODE", "0")
    name, over = SWITCHES[case]
    jcfg, jparams, _, model = family_pair(name, **over)
    _close(_dense_logits(jcfg, jparams, model))
    _close(_paged_logits_one_shape(jcfg, jparams, model))


def test_blocks_hold_their_layers_window_and_rope():
    _, _, _, model = family_pair("qwen2-7b", attn_windows=(None, 5),
                                 rope_layers=(0, 1))
    assert [b.window for b in model.layers] == [None, 5]
    assert [b.rope_on for b in model.layers] == [False, True]
    _, _, _, model = family_pair("gemma-7b", sliding_window=7)
    assert [b.window for b in model.layers] == [7, 7]


@pytest.mark.parametrize("leaf,value", [
    ("attn_window", [-1, 6]), ("attn_window", None),
    ("rope_on", [1, 1]), ("rope_on", None),
])
def test_bridge_refuses_per_layer_leaves_off_the_config(leaf, value):
    _, _, tree, model = family_pair("qwen2-7b", attn_windows=(None, 5),
                                    rope_layers=(0, 1))
    tree = dict(tree, layers=dict(tree["layers"]))
    if value is None:
        del tree["layers"][leaf]
    else:
        tree["layers"][leaf] = np.asarray(value, np.int32)
    with pytest.raises(ValueError, match=leaf):
        params_from_jax(tree, model.cfg, "cpu")


@pytest.mark.parametrize("kind", ["rms_head", "ln_head", "rms_full"])
def test_qk_normalize_matches_jax(kind):
    from distributed_llm_inferencing_tpu.models import transformer as jtf
    from distributed_llm_inferencing_tpu.models.config import (
        ModelConfig as JaxConfig)
    rng = np.random.default_rng(3)
    B, s, H, hd = 2, 3, 4, 8
    t = rng.normal(size=(B, s, H, hd)).astype(np.float32)
    scale = rng.normal(size=(hd if kind == "rms_head" else H * hd,)
                       ).astype(np.float32)
    jcfg = JaxConfig(qk_norm=kind, norm_eps=1e-6)
    want = np.asarray(jtf._qk_normalize(jax.numpy.asarray(t),
                                        {"scale": jax.numpy.asarray(scale)},
                                        jcfg))
    got = norms.qk_normalize(torch.from_numpy(t), torch.from_numpy(scale),
                             kind, 1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("over", [
    {"qk_norm": "rms_head"}, {"attn_windows": (None, 8)},
    {"attn_softcap": 50.0}, {"logit_softcap": 30.0},
    {"post_block_norms": True}, {"sublayer_postnorm_only": True},
    {"rope_layers": (1, 0)}, {"residual_scale": 0.5},
    {"logit_scale": 0.5},
])
def test_tp_refuses_the_switches_by_name(over):
    """tp serves every dense switch (tests/test_torch_tp_families.py
    holds them to the JAX package), and since ROADMAP item 9.8 the
    experts, latent attention, ``qkv_clip`` and sinks too
    (tests/test_torch_ep.py)."""
    cfg = treg.get_config("llama-3-8b")
    if "attn_windows" in over or "rope_layers" in over:
        cfg = cfg.replace(num_layers=2)
    cfg = cfg.replace(**over)
    validate_spec(MeshSpec(tp=2), cfg)


def test_per_layer_switches_of_the_wrong_length_are_refused():
    _, _, _, model = family_pair("qwen2-7b")
    with pytest.raises(NotImplementedError, match="attn_windows"):
        Transformer(model.cfg.replace(attn_windows=(None,)), {})


@pytest.mark.parametrize("window", [None, 7])
def test_split_arithmetic_with_softcap_matches_plain(window):
    """The decode kernels' split-KV arithmetic (the dense and the paged
    form, in plain PyTorch) with a score cap equals the plain
    versions: the cap acts on each score before the running max, so
    the log-sum-exp merge is unchanged."""
    from distributed_llm_inferencing_tpu_torch.ops import (
        flash_attention as fa, paged_attention as pa)
    g = torch.Generator().manual_seed(5)
    q = torch.randn(3, 1, 8, 16, generator=g)
    k, v = (torch.randn(3, 40, 2, 16, generator=g) for _ in range(2))
    lens = torch.tensor([1, 23, 40], dtype=torch.int32)
    kw = dict(sliding_window=window, softcap=0.6)
    torch.testing.assert_close(
        fa.flash_decode_split_ref(q, k, v, lens, split=8, **kw),
        fa.flash_decode_ref(q, k, v, lens, **kw), rtol=1e-5, atol=1e-5)
    kp, vp = (torch.randn(16, 4, 2, 16, generator=g) for _ in range(2))
    bt = torch.randperm(15, generator=g)[:12].reshape(3, 4).int() + 1
    lens = torch.tensor([0, 9, 16], dtype=torch.int32)
    torch.testing.assert_close(
        pa.paged_flash_decode_split_ref(q, kp, vp, bt, lens, split=8, **kw),
        pa.paged_flash_decode_ref(q, kp, vp, bt, lens, **kw),
        rtol=1e-5, atol=1e-5)
