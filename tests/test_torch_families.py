"""The dense model families of the port against the JAX package's, at the
model level, on the CPU in f32.

Each family is a tiny variant of one registry row (``FAMILIES``): the
JAX row ``.replace()``d to width 64 and 2 layers with the same switches,
and the port's config built from it through ``dataclasses.asdict``, so
both sides run the same configuration. The JAX init leaves biases at 0
and norms at 1; ``family_pair`` moves every bias, norm scale and norm
bias by a seeded draw so those adds are under test, then bridges the tree
bit for bit. Held here:

- the registry copy of every family row, field for field;
- the bridge: every leaf of every family bitwise, none left over;
- the dense path: a right-padded prefill and 6 decode steps, logits
  within 1e-4 of ``transformer.prefill`` / ``decode_step``;
- ``apply_rope`` partial and interleaved against JAX ``ops/rope.py`` at
  1e-6;
- what stays refused: the features outside the families, and tp where
  a family's shapes do not divide.

The paged path and the quantized forms are in
``test_torch_families_paged.py``; greedy tokens through the engines and
batchers in ``test_torch_families_engine.py`` and
``test_torch_families_batcher.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inferencing_tpu.models import transformer as jtf
from distributed_llm_inferencing_tpu.models.params import (
    init_params as jax_init_params)
from distributed_llm_inferencing_tpu.models.registry import (
    get_config as jax_config)
from distributed_llm_inferencing_tpu.ops import rope as jrope
from distributed_llm_inferencing_tpu.ops.kvcache import (
    init_cache as jax_init_cache)
from distributed_llm_inferencing_tpu_torch.models import registry as treg
from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig
from distributed_llm_inferencing_tpu_torch.models.params import (
    param_shapes, params_from_jax)
from distributed_llm_inferencing_tpu_torch.models.transformer import (
    Transformer)
from distributed_llm_inferencing_tpu_torch.ops import rope as trope
from distributed_llm_inferencing_tpu_torch.ops.kvcache import init_cache
from distributed_llm_inferencing_tpu_torch.parallel.mesh import (
    MeshSpec, validate_spec)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's plain versions on one intra-op thread for the module
    that defines or imports this fixture (restored after it). The suite
    runs its files in parallel processes, where torch's default of a
    thread per core oversubscribes the machine and its many tiny ops
    wait on descheduled threads: beside seven busy processes, a 0.6 s
    test of tests/test_torch_kvtier.py took 17.6 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# the JAX package's forward entry points, jitted once per config (static)
# and shapes: its eager op-by-op dispatch retraces every scan per call
jit_prefill, jit_decode_step, jit_paged_prefill_tail, jit_paged_decode_step = (
    jax.jit(f, static_argnums=1) for f in (
        jtf.prefill, jtf.decode_step, jtf.paged_prefill_tail,
        jtf.paged_decode_step))
_TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, num_kv_heads=4, head_dim=16,
             max_position_embeddings=128)
# registry row -> its tiny variant's changes beyond _TINY; one row per
# distinct set of switches (gpt2's sizes share tiny-gpt2's, opt-1.3b
# opt-125m's, pythia-1.4b pythia-6.9b's)
FAMILIES = {
    "tiny-gpt2": {},
    "opt-125m": {},
    "opt-350m": {"embed_proj_dim": 32},             # post-norm, projections
    "qwen2-7b": {"num_kv_heads": 2},
    "qwen2-0.5b": {"num_kv_heads": 2},               # tied
    "gemma-7b": {"head_dim": 32, "embed_scale": 64 ** 0.5},
    "gemma-2b": {"head_dim": 32, "num_kv_heads": 1,
                 "embed_scale": 64 ** 0.5},
    "pythia-6.9b": {},
    "phi-2": {},                                     # rope_pct 0.4: 6 of 16
    "falcon-7b": {"num_heads": 5, "num_kv_heads": 1},   # an odd group
    "falcon-rw-1b": {"alibi_scale": 16 ** -0.5},
    "bloom-7b1": {},
    "mpt-7b": {},
    "gpt-j-6b": {"head_dim": 32, "num_heads": 2, "num_kv_heads": 2},
}
NEW_ROWS = ["gpt2", "gpt2-medium", "gpt2-large", "gpt2-xl", "opt-125m",
            "opt-350m", "opt-1.3b", "qwen2-7b", "qwen2-0.5b", "gemma-7b",
            "gemma-2b", "pythia-6.9b", "pythia-1.4b", "phi-2", "falcon-7b",
            "falcon-rw-1b", "bloom-7b1", "mpt-7b", "gpt-j-6b", "tiny-gpt2"]


def tiny_config(name, **over):
    """(JAX config, port config) of ``name``'s tiny variant in f32."""
    size = {**_TINY, **FAMILIES[name]}
    if name == "tiny-gpt2":
        size = {"num_layers": 2}
    jcfg = jax_config(name).replace(dtype="float32", attn_backend="xla",
                                    **size, **over)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _perturb(np_tree, seed):
    """Every bias, norm scale and norm bias of the tree moved by a seeded
    normal draw (std 0.1), in its own dtype."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        keys = [str(getattr(k, "key", "")) for k in path]
        if keys[-1] in ("b", "bias") or (
                keys[-1] == "scale" and any("norm" in k for k in keys)):
            return (a + rng.normal(0, 0.1, a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(move, np_tree)


def family_pair(name, seed=1, **over):
    """(JAX config, JAX params, numpy tree, port model) on one set of
    weights: the JAX init, perturbed, bridged."""
    jcfg, tcfg = tiny_config(name, **over)
    tree = _perturb(jax.tree.map(
        np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed))), seed)
    model = Transformer(tcfg, params_from_jax(tree, tcfg, "cpu"))
    return jcfg, jax.tree.map(jnp.asarray, tree), tree, model


@pytest.mark.parametrize("name", NEW_ROWS)
def test_registry_rows_match_reference(name):
    assert dataclasses.asdict(treg.get_config(name)) == \
        dataclasses.asdict(jax_config(name))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_params_from_jax_bitwise(name):
    """Every leaf of the tree lands in the flat dict bit for bit, under
    the name and shape ``param_shapes`` gives, and nothing else does."""
    jcfg, _, tree, model = family_pair(name)
    port = params_from_jax(tree, model.cfg, "cpu")
    assert set(port) == set(param_shapes(model.cfg))
    flat = {}
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(k.key) for k in path]
        if keys[0] == "layers":
            for i in range(jcfg.num_layers):
                flat[".".join(["layers", str(i)] + keys[1:])] = a[i]
        else:
            flat[".".join(keys)] = a
    assert set(flat) == set(port)
    for k, a in flat.items():
        np.testing.assert_array_equal(port[k].numpy(), a, err_msg=k)
    cfg = model.cfg
    assert ("lm_head.w" in port) != cfg.tie_word_embeddings
    assert ("final_norm.scale" in port) != cfg.post_norm
    assert ("embed.positions" in port) == (
        cfg.position_embedding == "learned")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_dense_logits_match_jax(name):
    jcfg, jparams, _, model = family_pair(name)
    rng = np.random.default_rng(0)
    B, S0, max_seq = 2, 16, 48
    lens = np.asarray([11, 16], np.int32)
    toks = rng.integers(0, jcfg.vocab_size, (B, S0)).astype(np.int32)
    toks[0, 11:] = 0                                   # right padding
    jlog, jcache = jit_prefill(jparams, jcfg, jnp.asarray(toks),
                               jnp.asarray(lens),
                               jax_init_cache(jcfg, B, max_seq))
    with torch.inference_mode():
        tcache = init_cache(model.cfg, B, max_seq, device="cpu")
        tlog, tcache = model.prefill(torch.from_numpy(toks).long(),
                                     torch.from_numpy(lens), tcache)
        for b, n in enumerate(lens):   # rows past a length are never read
            np.testing.assert_allclose(tlog[b, :n].numpy(),
                                       np.asarray(jlog)[b, :n], **TOL)
        for _ in range(6):                              # teacher-forced
            nxt = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
            jlog, jcache = jit_decode_step(jparams, jcfg, jnp.asarray(nxt),
                                           jcache)
            tlog, tcache = model.decode_step(torch.from_numpy(nxt).long(),
                                             tcache)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), **TOL)


@pytest.mark.parametrize("pct,interleaved,hd", [
    (0.25, False, 32), (0.4, False, 16), (0.25, True, 32), (1.0, True, 16),
])
def test_apply_rope_partial_and_interleaved_match_jax(pct, interleaved, hd):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
    ref = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4,
                                      pct, interleaved))
    tx, tp = torch.from_numpy(x), torch.from_numpy(pos)
    out = trope.apply_rope(tx, tp, 1e4, pct, interleaved)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    rot = trope.rotary_dim(hd, pct)
    np.testing.assert_array_equal(out[..., rot:].numpy(), x[..., rot:])
    cs = trope.rope_cos_sin(tp, rot, 1e4)      # the model's shared rows
    assert cs[0].shape == (2, 5, 1, rot // 2)
    torch.testing.assert_close(
        trope.apply_rope(tx, None, 1e4, pct, interleaved, cos_sin=cs), out,
        rtol=0, atol=0)


@pytest.mark.parametrize("over", [
    {"kv_quant": "fp8"}, {"qk_norm": "rms_whole"}, {"activation": "swish"},
])
def test_features_outside_the_families_stay_refused(over):
    _, cfg = tiny_config("tiny-gpt2")
    with pytest.raises(NotImplementedError):
        Transformer(cfg.replace(**over), {})


@pytest.mark.parametrize("name", ["gpt2", "bloom-7b1", "gemma-7b",
                                  "pythia-6.9b", "qwen2-7b"])
def test_tp_refused_for_the_families(name):
    """tp shards every dense family (tests/test_torch_tp_families.py
    serves them); what stays refused is a shape tp does not divide:
    gpt2's odd vocabulary of 50257 rows at tp=2."""
    cfg = treg.get_config(name)
    if cfg.vocab_size % 2:
        with pytest.raises(ValueError, match="vocab_size"):
            validate_spec(MeshSpec(tp=2), cfg)
    else:
        validate_spec(MeshSpec(tp=2), cfg)
    validate_spec(MeshSpec(), cfg)                   # tp=1 serves
