"""Tensor parallelism for every dense family and switch of the port,
against the JAX package on the CPU's virtual mesh (f32).

- parallel/sharding.py: every rank's shard of every leaf of one tiny
  variant per dense family (``test_torch_families.FAMILIES``; falcon-7b's
  at 4 heads over 1 kv head, so tp=2 divides it), float and int4, equals
  that rank's shard of the JAX ``shard_params`` placement (its
  ``param_specs``), bit for bit; where the JAX package replicates and the
  port cuts (k and v over replicated kv heads, the per-head q/k norm
  scales), every local q head's kv head (and norm slice) is the one its
  global q head reads.
- The engine at tp=2 (two gloo ranks; one follower serves every case,
  ``DLI_TP_KEEP_GROUPS``): teacher-forced logits within 1e-4 of the JAX tp=2
  forward on the same weights, and greedy tokens equal to the JAX
  forward's greedy chain, for every family and every dense switch
  (``test_torch_switches.SWITCHES``'s, four to a case); every rank's
  collectives exact by
  the count rule of models/transformer.py (one all-reduce per parallel
  block, one more per "rms_full" layer).
- Replicated kv heads: H=8 over 1 kv head at tp=2, and H=12 over 3 kv
  heads at tp=4 (a rank's q heads read unequal runs of two kv heads).
- A row-parallel bias added once: gpt2's o and down biases drawn large
  enough that adding them twice would miss the tolerance tenfold.
"""

import math
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inferencing_tpu.models.params import (
    init_params as jax_init_params)
from distributed_llm_inferencing_tpu.ops.kvcache import (
    init_cache as jax_init_cache)
from distributed_llm_inferencing_tpu.parallel import sharding as jsh
from distributed_llm_inferencing_tpu.parallel.mesh import (
    MeshSpec as JaxMeshSpec, create_mesh)
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.models.transformer import (
    Transformer)
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.parallel import sharding as tsh
from distributed_llm_inferencing_tpu_torch.parallel.mesh import MeshSpec
from distributed_llm_inferencing_tpu_torch.runtime import lockstep
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
import test_torch_families as ttf
from test_torch_families import (  # noqa: F401
    _perturb, jit_decode_step, jit_prefill, one_torch_thread)

TOL = dict(rtol=1e-4, atol=1e-4)
# registry row -> its tiny variant under tp=2 (FAMILIES', and falcon-7b's
# odd group of 5 heads made 4 over its one kv head)
TP_FAMILIES = dict(ttf.FAMILIES, **{"falcon-7b": {"num_heads": 4,
                                                  "num_kv_heads": 1}})
# every dense switch (tests/test_torch_switches.py's SWITCHES) under tp,
# grouped four to a case on the rows that take them there: case ->
# (tiny registry row, switches)
TP_SWITCHES = {
    # the flat q/k norm (its sums of squares over the ranks), a windowed
    # second layer, a NoPE first layer, granite's residual scale
    "rms_full-windows-nope-residual_scale": (
        "qwen2-7b", {"qk_norm": "rms_full", "attn_windows": (None, 5),
                     "rope_layers": (0, 1), "residual_scale": 0.4}),
    # qwen3's per-head norm after RoPE, olmo2's post-only norms
    "rms_head-after_rope-postnorm_only": (
        "qwen2-7b", {"qk_norm": "rms_head", "qk_norm_after_rope": True,
                     "sublayer_postnorm_only": True}),
    # gemma-2's score and logit caps, window and sandwich norms, over
    # gemma-2b's one kv head (replicated at tp=2)
    "softcaps-window-sandwich": (
        "gemma-2b", {"attn_softcap": 0.05, "sliding_window": 6,
                     "logit_softcap": 0.1, "post_block_norms": True}),
    # cohere's per-head norms and logit scale on a parallel block with a
    # residual scale (two all-reduces per layer), nemotron's squared ReLU
    "ln_head-logit_scale-parallel_scaled-relu2": (
        "pythia-6.9b", {"qk_norm": "ln_head", "logit_scale": 3.0,
                        "residual_scale": 0.4, "activation": "relu2"}),
}
PROMPTS = [[3, 17, 52, 9, 1, 30, 44], list(range(5, 25))]
NEW = 5


def tp_config(name, **over):
    """(JAX config, port config) of ``name``'s tiny tp variant in f32."""
    sizes = dict(TP_FAMILIES[name], **over)
    saved = ttf.FAMILIES.get(name)
    ttf.FAMILIES[name] = sizes
    try:
        return ttf.tiny_config(name)
    finally:
        if saved is None:
            del ttf.FAMILIES[name]
        else:
            ttf.FAMILIES[name] = saved


def _tree(jcfg, seed=1, grow=None):
    """The JAX init, every bias and norm moved by a seeded draw (as
    ``family_pair``); ``grow``: leaf names whose biases are scaled by it."""
    tree = _perturb(jax.tree.map(
        np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed))), seed)
    if grow:
        for name, factor in grow.items():
            leaf = dict(tree["layers"][name])
            rng = np.random.default_rng(seed + 7)
            leaf["b"] = (rng.normal(0, factor, leaf["b"].shape)
                         .astype(leaf["b"].dtype))
            tree["layers"] = dict(tree["layers"], **{name: leaf})
    return tree


@pytest.fixture(scope="module")
def _idle_groups():
    """Stop the module's kept tp groups at its end; no follower stays."""
    yield
    lockstep.stop_idle_groups()
    assert not [p for p in multiprocessing.active_children()
                if p.name.startswith("dli-tp-rank")]


@pytest.fixture
def kept_groups(_idle_groups, monkeypatch):
    """Each engine's tp group kept when it closes and taken by the next
    of its size (``DLI_TP_KEEP_GROUPS``): one spawn per world size for
    the module."""
    monkeypatch.setenv("DLI_TP_KEEP_GROUPS", "1")


# ---- the placement --------------------------------------------------------

def _kv_reads(cfg, tp, rank):
    """The global kv head each local q head of ``rank`` reads."""
    hl, group = cfg.num_heads // tp, cfg.num_heads // cfg.num_kv_heads
    return [(rank * hl + i) // group for i in range(hl)]


def _check_cut(name, cfg, tp, rank, mine, full):
    """A leaf the JAX package replicates and the port cuts by heads: the
    local head (q) or the kv head behind each local q head (k, v) holds
    the global head's columns."""
    leaf = name.split(".")[2]
    hd = cfg.head_dim
    hl = cfg.num_heads // tp
    if leaf == "q_norm":   # per-head scales, cut with the q heads
        np.testing.assert_array_equal(
            mine, full[rank * hl * hd:(rank + 1) * hl * hd], err_msg=name)
        return
    assert leaf in ("k", "v", "k_norm"), name
    kv_l = mine.shape[-1] // hd
    per = hl // kv_l
    for i, h in enumerate(_kv_reads(cfg, tp, rank)):
        j = i // per
        np.testing.assert_array_equal(
            mine[..., j * hd:(j + 1) * hd], full[..., h * hd:(h + 1) * hd],
            err_msg=f"{name}: local q head {i}")


def _placement_case(name, quant, tp=2, **over):
    jcfg, tcfg = tp_config(name, **over)
    jcfg, tcfg = (c.replace(quant=quant) for c in (jcfg, tcfg))
    params = jax_init_params(jcfg, jax.random.PRNGKey(4))
    spec = JaxMeshSpec(tp=tp)
    mesh = create_mesh(spec)
    with mesh:
        placed = jsh.shard_params(params, mesh, jcfg, spec)
    full = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    devices = list(mesh.devices.flat)
    flat = jax.tree_util.tree_flatten_with_path(placed)[0]
    whole = {tuple(p.key for p in path): a for path, a in
             jax.tree_util.tree_flatten_with_path(params)[0]}
    for rank in range(tp):
        mine = tsh.shard_params(dict(full), tcfg, MeshSpec(tp=tp), rank)
        seen = set()
        for path, arr in flat:
            keys = [p.key for p in path]
            [shard] = [s for s in arr.addressable_shards
                       if s.device == devices[rank]]
            local = np.asarray(shard.data)
            entire = whole.get(tuple(keys))
            entire = None if entire is None else np.asarray(entire)
            names = ([(".".join(["layers", str(i)] + keys[1:]), i)
                      for i in range(tcfg.num_layers)]
                     if keys[0] == "layers" else [(".".join(keys), None)])
            jax_cuts = "tp" in tuple(arr.sharding.spec)
            for n, i in names:
                ours = mine[n].numpy()
                want = local if i is None else local[i]
                if jax_cuts or tsh.split_dim(n, tcfg) is None:
                    np.testing.assert_array_equal(ours, want, err_msg=n)
                else:   # replicated there, cut here
                    _check_cut(n, tcfg, tp, rank, ours,
                               entire if i is None else entire[i])
                seen.add(n)
        assert seen == set(mine)


@pytest.mark.parametrize("quant", [None, "int4"], ids=["float", "int4"])
@pytest.mark.parametrize("name", list(TP_FAMILIES))
def test_shards_match_jax_placement(name, quant):
    _placement_case(name, quant)


@pytest.mark.parametrize("case,tp,over", [
    ("ln_head", 2, {"qk_norm": "ln_head"}),
    ("rms_full-replicated", 4, {"qk_norm": "rms_full", "num_heads": 8,
                                "num_kv_heads": 2}),
    ("kv12-3-tp4", 4, {"num_heads": 12, "num_kv_heads": 3}),
])
def test_cut_leaves_match_jax_heads(case, tp, over):
    """The leaves the JAX package replicates and the port cuts: per-head
    q/k norm scales, and k/v over replicated kv heads (also where a
    rank's q heads read two kv heads)."""
    _placement_case("qwen2-7b", None, tp=tp, **over)


# ---- the engine against the JAX forward -----------------------------------

def _jax_greedy(jcfg, tree, tp):
    """The JAX forward on a tp mesh over the placed weights: prefill
    logits [B, S, V] and the greedy chain's tokens [B, NEW] with the
    logits of each decode step [NEW - 1, B, V]."""
    spec = JaxMeshSpec(tp=tp)
    mesh = create_mesh(spec)
    B = len(PROMPTS)
    toks = np.zeros((B, 32), np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, :len(p)] = p
    lens = jnp.asarray([len(p) for p in PROMPTS], jnp.int32)
    with mesh:
        params = jsh.shard_params(jax.tree.map(jnp.asarray, tree), mesh,
                                  jcfg, spec)
        pre, cache = jit_prefill(params, jcfg, jnp.asarray(toks), lens,
                                 jax_init_cache(jcfg, B, 64))
        pre = np.asarray(pre)
        cur = pre[np.arange(B), np.asarray(lens) - 1].argmax(-1)
        chain, steps = [cur], []
        for _ in range(NEW - 1):
            lg, cache = jit_decode_step(params, jcfg,
                                        jnp.asarray(cur, jnp.int32)[:, None],
                                        cache)
            lg = np.asarray(lg[:, 0])
            steps.append(lg)
            cur = lg.argmax(-1)
            chain.append(cur)
    return pre, np.stack(chain, 1), np.stack(steps)


def _per_pass(cfg, tp_world):
    """The count rule's all-reduces per weight pass."""
    per_layer = 1 if cfg.parallel_residual and not (
        cfg.post_block_norms or cfg.sublayer_postnorm_only
        or cfg.residual_scale is not None) else 2
    per_layer += cfg.qk_norm == "rms_full"
    return 1 + cfg.num_layers * per_layer


def _engine_case(jcfg, tcfg, tree, tp=2):
    pre_j, chain, dec_j = _jax_greedy(jcfg, tree, tp)
    eng = InferenceEngine(tcfg, params_from_jax(tree, tcfg, "cpu"),
                          mesh_spec=MeshSpec(tp=tp), max_seq=64,
                          device="cpu")
    try:
        pre, dec = eng.teacher_forced(PROMPTS, chain[:, :-1].T.tolist())
        for i, p in enumerate(PROMPTS):
            np.testing.assert_allclose(pre[i, :len(p)].numpy(),
                                       pre_j[i, :len(p)], **TOL)
        np.testing.assert_allclose(dec.numpy(), dec_j, **TOL)
        eng.reset_counts()
        res = eng.generate(PROMPTS, NEW, sampling=SamplingParams.greedy())
        assert res.tokens == chain.tolist()
        want = {"all_reduce": _per_pass(tcfg, tp) * res.steps,
                "gather": res.steps, "broadcast": res.steps}
        stats = eng.rank_stats()
        assert [s["rank"] for s in stats] == list(range(tp))
        assert all(s["collectives"] == want for s in stats), (stats, want)
        return eng.model, pre_j
    finally:
        eng.close()


@pytest.mark.parametrize("name", list(TP_FAMILIES))
def test_family_tp2_matches_jax_tp2(name, kept_groups):
    jcfg, tcfg = tp_config(name)
    _engine_case(jcfg, tcfg, _tree(jcfg))


@pytest.mark.parametrize("case", list(TP_SWITCHES))
def test_switch_tp2_matches_jax_tp2(case, kept_groups):
    name, over = TP_SWITCHES[case]
    jcfg, tcfg = tp_config(name, **over)
    _engine_case(jcfg, tcfg, _tree(jcfg))


@pytest.mark.parametrize("case,tp,name,over", [
    # gemma-2b's MQA: each rank's 4 q heads read the one kv head
    ("H8-Hkv1-tp2", 2, "gemma-2b", {"num_heads": 8}),
    # rank 1's q heads 3, 4, 5 read kv heads 0, 1, 1; its rms_full k
    # norms count each global kv head once
    ("H12-Hkv3-tp4", 4, "qwen2-7b",
     {"num_heads": 12, "num_kv_heads": 3, "qk_norm": "rms_full"}),
])
def test_replicated_kv_heads_match_jax(case, tp, name, over, kept_groups):
    jcfg, tcfg = tp_config(name, **over)
    model, _ = _engine_case(jcfg, tcfg, _tree(jcfg), tp=tp)
    block = model.layers[0]
    hl = tcfg.num_heads // tp
    kv_l = hl // math.gcd(hl, tcfg.num_heads // tcfg.num_kv_heads)
    assert (block.heads, block.kv_heads) == (hl, kv_l)
    assert model.layers[0].k.w.shape[-1] == kv_l * tcfg.head_dim


def test_row_bias_is_added_once(kept_groups):
    """gpt2's o and down biases at std 1 (the block's output is ~0.1):
    tp=2 equals the JAX forward within 1e-4, where the same weights with
    those biases doubled (what an all-reduce of biased partials would
    add) miss it by more than ten times the tolerance."""
    jcfg, tcfg = tp_config("tiny-gpt2")
    tree = _tree(jcfg, grow={"o": 1.0, "down": 1.0})
    _, pre_j = _engine_case(jcfg, tcfg, tree)
    params = params_from_jax(tree, tcfg, "cpu")
    for i in range(tcfg.num_layers):
        for n in ("o", "down"):
            params[f"layers.{i}.{n}.b"] = params[f"layers.{i}.{n}.b"] * 2
    doubled = Transformer(tcfg, params)
    from distributed_llm_inferencing_tpu_torch.ops.kvcache import init_cache
    toks = torch.tensor([PROMPTS[1]])
    with torch.inference_mode():
        lg, _ = doubled.prefill(toks, torch.tensor([len(PROMPTS[1])],
                                                   dtype=torch.int32),
                                init_cache(tcfg, 1, 64, device="cpu"))
    off = np.abs(lg[0].numpy() - pre_j[1, :len(PROMPTS[1])]).max()
    assert off > 10 * TOL["atol"], off
