"""The port's tensor-parallel engine serving against the JAX package's, on
the CPU.

- ops/quant.py: ``repack_int4_rows`` and ``unpack_int4(p4, chunks)`` give
  the JAX functions' bytes for 2 and 4 chunks.
- ``q4_matmul_row_ref`` (and the CPU wrapper, which is it) against the
  JAX ``q4_matmul_row`` run as tests/test_quant_partition.py runs it: a
  2-device CPU mesh, the Pallas kernel in interpret mode, 1e-4.
- parallel/sharding.py: every rank's shard of every tensor at tp=2
  (float, int4) equals that rank's shard of the JAX ``shard_params``
  placement (its ``param_specs``), bit for bit.
- The engine at tp=2 (two gloo ranks, two processes): the same greedy
  tokens as the JAX ``InferenceEngine`` on a tp=2 mesh and as the port at
  tp=1, for float and int4 weights (the JAX int4 kernels in interpret
  mode); teacher-forced logits within 1e-4 of the JAX tp=2 forward's
  and of the port's tp=1 (f32: sums in another order).
- The worker: ``"mesh": {"tp": 2}`` loads and serves; batched + tp with
  a host KV tier, dp > 1, batched sp and a tp that does not divide the
  heads are 400s; /unload_model leaves no follower process alive.

Each tp engine spawns one follower (the port's own entry point, which
imports neither jax nor this module) and joins it through a file store in
a fresh temporary directory (no TCP port, so parallel test workers do not
collide), within parallel/mesh.py's join timeout (120 s) and
runtime/lockstep.py's stop timeout (60 s).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import requests
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from distributed_llm_inferencing_tpu.models import transformer as jtr
from distributed_llm_inferencing_tpu.models.params import (
    init_params as jax_init_params)
from distributed_llm_inferencing_tpu.models.registry import (
    get_config as jax_config)
from distributed_llm_inferencing_tpu.ops import quant as jq
from distributed_llm_inferencing_tpu.ops.kvcache import (
    init_cache as jax_init_cache)
from distributed_llm_inferencing_tpu.ops.pallas import quant_matmul as jqm
from distributed_llm_inferencing_tpu.ops.sampling import (
    SamplingParams as JaxSamplingParams)
from distributed_llm_inferencing_tpu.parallel import sharding as jsh
from distributed_llm_inferencing_tpu.parallel.mesh import (
    MeshSpec as JaxMeshSpec, create_mesh)
from distributed_llm_inferencing_tpu.runtime.engine import (
    InferenceEngine as JaxEngine)
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.models.registry import get_config
from distributed_llm_inferencing_tpu_torch.ops import quant as tq
from distributed_llm_inferencing_tpu_torch.ops import quant_matmul as tqm
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.parallel import sharding as tsh
from distributed_llm_inferencing_tpu_torch.parallel.mesh import (
    MeshSpec, validate_spec)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from distributed_llm_inferencing_tpu_torch.runtime.worker import WorkerAgent
from test_torch_families import one_torch_thread  # noqa: F401

PROMPTS = [[3, 17, 52, 9, 1, 30, 44], list(range(5, 45))]
FORCED = [[7, 11], [250, 0], [31, 64]]
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _int4_leaf(din, dout, seed):
    rng = np.random.default_rng(seed)
    return jq.quantize_weight_int4(
        jnp.asarray(rng.standard_normal((din, dout)), jnp.float32))


# ---- ops/quant.py: the chunk-local layout --------------------------------

@pytest.mark.parametrize("chunks", [2, 4])
@pytest.mark.parametrize("din,dout", [(96, 160), (64, 8), (512, 24)])
def test_repack_and_chunked_unpack_match_jax(chunks, din, dout):
    leaf = _int4_leaf(din, dout, din + chunks)
    tleaf = {k: _t(v) for k, v in leaf.items()}
    jc, tc = jq.repack_int4_rows(leaf, chunks), tq.repack_int4_rows(tleaf,
                                                                   chunks)
    np.testing.assert_array_equal(tc["p4"].numpy(), np.asarray(jc["p4"]))
    assert tuple(tc["chunked"].shape) == jc["chunked"].shape == (chunks, 0)
    assert tq.pack_chunks(tc) == jq.pack_chunks(jc) == chunks
    np.testing.assert_array_equal(tq.unpack_int4(tc["p4"], chunks).numpy(),
                                  np.asarray(jq.unpack_int4(jc["p4"],
                                                            chunks)))
    # values are unchanged: only the bytes' places move
    np.testing.assert_array_equal(tq.dequantize_weight(tc).numpy(),
                                  tq.dequantize_weight(tleaf).numpy())
    assert tq.repack_int4_rows(tc, chunks) is tc
    with pytest.raises(ValueError):          # chunked for another count
        tq.repack_int4_rows(tc, 2 * chunks)
    with pytest.raises(ValueError):          # din does not split
        tq.repack_int4_rows(tleaf, din)


def test_q4_matmul_row_ref_matches_jax_partitioned_kernel():
    leaf = _int4_leaf(64, 256, seed=3)
    ch = jq.repack_int4_rows(leaf, 2)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((4, 64)), jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2), ("tp",))
    p4 = jax.device_put(ch["p4"], NamedSharding(mesh, P("tp", None)))
    sc = jax.device_put(ch["scale"], NamedSharding(mesh, P(None)))
    xs = jax.device_put(x, NamedSharding(mesh, P(None, "tp")))
    ref = jax.jit(lambda a, p, s: jqm.q4_matmul_row(
        a, p, s, interpret=True, chunks=2))(xs, p4, sc)
    tp4, tsc = _t(ch["p4"]), _t(ch["scale"])
    out = tqm.q4_matmul_row_ref(_t(x), tp4, tsc, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LOGIT_TOL)
    assert torch.equal(tqm.q4_matmul_row(_t(x), tp4, tsc, 2), out)
    # the two ranks' halves, each one self-contained chunk, sum to it
    parts = [tqm.q4_linear(_t(x)[:, 32 * r:32 * (r + 1)],
                           {"p4": tp4[16 * r:16 * (r + 1)], "scale": tsc,
                            "chunked": torch.zeros(2, 0, dtype=torch.int8)},
                           shards=2) for r in range(2)]
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(),
                               np.asarray(ref), **LOGIT_TOL)


# ---- parallel/sharding.py against the JAX placement ----------------------

def _jax_tree(quant, seed=0):
    cfg = jax_config("tiny-llama").replace(dtype="float32", quant=quant)
    return cfg, jax_init_params(cfg, jax.random.PRNGKey(seed))


@pytest.mark.parametrize("quant", [None, "int4"])
def test_shard_params_matches_jax_placement(quant):
    jcfg, params = _jax_tree(quant, seed=4)
    spec = JaxMeshSpec(tp=2)
    mesh = create_mesh(spec)
    with mesh:
        placed = jsh.shard_params(params, mesh, jcfg, spec)
    tcfg = get_config("tiny-llama").replace(dtype="float32", quant=quant)
    full = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    devices = list(mesh.devices.flat)
    flat = jax.tree_util.tree_flatten_with_path(placed)[0]
    for rank in range(2):
        mine = tsh.shard_params(dict(full), tcfg, MeshSpec(tp=2), rank)
        seen = set()
        for path, arr in flat:
            keys = [p.key for p in path]
            [shard] = [s for s in arr.addressable_shards
                       if s.device == devices[rank]]
            local = np.asarray(shard.data)
            if keys[0] == "layers":
                for i in range(tcfg.num_layers):
                    name = ".".join(["layers", str(i)] + keys[1:])
                    np.testing.assert_array_equal(
                        mine[name].numpy(), local[i], err_msg=name)
                    seen.add(name)
            else:
                name = ".".join(keys)
                np.testing.assert_array_equal(mine[name].numpy(), local,
                                              err_msg=name)
                seen.add(name)
        assert seen == set(mine)
        if quant == "int4":
            assert tuple(mine["layers.0.o.chunked"].shape) == (2, 0)
            assert "layers.0.up.chunked" not in mine


def test_validate_spec_refuses_what_the_slice_does_not_serve():
    cfg = get_config("tiny-llama")      # H=8, Hkv=4, I=128, V=256, L=4
    validate_spec(MeshSpec(tp=2), cfg)
    validate_spec(MeshSpec(tp=4), cfg.replace(quant="int4"))
    validate_spec(MeshSpec(tp=8), cfg)  # tp > Hkv: the kv heads replicate
    # pp and sp and their compositions serve (later slices)
    for spec in (MeshSpec(pp=2), MeshSpec(sp=2, tp=2), MeshSpec(pp=4),
                 MeshSpec(pp=2, sp=2, tp=2)):
        validate_spec(spec, cfg)
    with pytest.raises(NotImplementedError):   # item 9.16
        validate_spec(MeshSpec(dp=2), cfg)
    with pytest.raises(ValueError, match="dense model"):   # as JAX
        validate_spec(MeshSpec(ep=2), cfg)
    with pytest.raises(ValueError):     # pp must divide the 4 layers
        validate_spec(MeshSpec(pp=3), cfg)
    with pytest.raises(ValueError):     # the ring shards the kv heads
        validate_spec(MeshSpec(sp=2, tp=8), cfg)
    # dbrx's clip and gpt-oss's sinks serve under tp (item 9.8)
    for over in ({"qkv_clip": 8.0}, {"attn_sinks": True}):
        validate_spec(MeshSpec(tp=2), cfg.replace(**over))
    with pytest.raises(ValueError):
        validate_spec(MeshSpec(tp=3), cfg)
    with pytest.raises(ValueError):     # tp <= Hkv=6 must divide it
        validate_spec(MeshSpec(tp=4), cfg.replace(num_heads=12,
                                                  num_kv_heads=6))
    with pytest.raises(ValueError):     # int4 down: din 36, not 4 x 2k
        validate_spec(MeshSpec(tp=4), cfg.replace(intermediate_size=36,
                                                  quant="int4"))
    with pytest.raises(ValueError):
        MeshSpec.from_dict({"tp": 2, "xp": 2})


# ---- the engine at tp=2 ---------------------------------------------------

@pytest.fixture(scope="module", params=[None, "int4"],
                ids=["float", "int4"])
def engines(request):
    quant = request.param
    mp = pytest.MonkeyPatch()
    mp.setenv("DLI_INT4_PALLAS", "interpret")
    jcfg, params = _jax_tree(quant)
    tcfg = get_config("tiny-llama").replace(dtype="float32", quant=quant)
    tree = jax.tree.map(np.asarray, params)
    jeng = JaxEngine(jcfg, params, mesh_spec=JaxMeshSpec(tp=2), max_seq=96)
    tp1 = InferenceEngine(tcfg, params_from_jax(tree, tcfg, "cpu"),
                          max_seq=96, device="cpu")
    tp2 = InferenceEngine(tcfg, params_from_jax(tree, tcfg, "cpu"),
                          mesh_spec=MeshSpec(tp=2), max_seq=96, device="cpu")
    yield jeng, tp1, tp2
    tp2.close()
    assert not tp2._leader.alive()
    mp.undo()


def test_tp2_greedy_tokens_match_jax_tp2_and_port_tp1(engines):
    jeng, tp1, tp2 = engines
    ref = jeng.generate(PROMPTS, max_new_tokens=10,
                        sampling=JaxSamplingParams.greedy()).tokens
    g = SamplingParams.greedy()
    assert tp2.generate(PROMPTS, max_new_tokens=10, sampling=g).tokens == ref
    assert tp1.generate(PROMPTS, max_new_tokens=10, sampling=g).tokens == ref
    # the eos path: the leader's tokens decide every rank's chunk count
    eos = ref[0][3]
    res = tp2.generate([PROMPTS[0]], max_new_tokens=10, sampling=g,
                       eos_token_id=eos)
    assert res.tokens[0] == ref[0][:ref[0].index(eos)]
    # sampling on the leader only, seeded as at tp=1
    a, b = (e.generate([PROMPTS[1]], max_new_tokens=8, seed=9).tokens
            for e in (tp1, tp2))
    assert a == b


def _jax_forced_logits(jeng):
    cfg, B = jeng.cfg, len(PROMPTS)
    tokens = np.zeros((B, 64), np.int32)
    for i, p in enumerate(PROMPTS):
        tokens[i, :len(p)] = p
    lengths = jnp.asarray([len(p) for p in PROMPTS], jnp.int32)
    cache = jax_init_cache(cfg, B, 96)
    with jeng.mesh:
        prefill = jax.jit(lambda p, t, ln, c: jtr.prefill(p, cfg, t, ln, c))
        pre, cache = prefill(jeng.params, jnp.asarray(tokens), lengths,
                             cache)
        step = jax.jit(lambda p, t, c: jtr.decode_step(p, cfg, t, c))
        outs = []
        for row in FORCED:
            lg, cache = step(jeng.params, jnp.asarray(row, jnp.int32)[:, None],
                             cache)
            outs.append(np.asarray(lg[:, 0]))
    return np.asarray(pre), np.stack(outs)


def test_tp2_logits_match_jax_tp2_and_port_tp1(engines):
    jeng, tp1, tp2 = engines
    pre2, dec2 = tp2.teacher_forced(PROMPTS, FORCED)
    pre1, dec1 = tp1.teacher_forced(PROMPTS, FORCED)
    jpre, jdec = _jax_forced_logits(jeng)
    assert pre2.shape == (2, 64, 256) and dec2.shape == (3, 2, 256)
    for i, p in enumerate(PROMPTS):       # the prompts' real rows
        n = len(p)
        np.testing.assert_allclose(pre2[i, :n].numpy(), jpre[i, :n],
                                   **LOGIT_TOL)
        np.testing.assert_allclose(pre2[i, :n].numpy(), pre1[i, :n].numpy(),
                                   **LOGIT_TOL)
    np.testing.assert_allclose(dec2.numpy(), jdec, **LOGIT_TOL)
    np.testing.assert_allclose(dec2.numpy(), dec1.numpy(), **LOGIT_TOL)
    last, _ = tp2.teacher_forced(PROMPTS, [], last_only=True)
    for i, p in enumerate(PROMPTS):
        assert torch.equal(last[i], pre2[i, len(p) - 1])


def test_tp2_ranks_count_the_same_collectives(engines):
    _, _, tp2 = engines
    tp2.reset_counts()
    L = tp2.cfg.num_layers
    res = tp2.generate([PROMPTS[0]], max_new_tokens=5,
                       sampling=SamplingParams.greedy())
    stats = tp2.rank_stats()
    assert [s["rank"] for s in stats] == [0, 1]
    passes = res.steps      # the prefill and 4 decode steps
    want = {"all_reduce": passes * (2 * L + 1), "gather": passes,
            "broadcast": passes}
    assert all(s["collectives"] == want for s in stats), stats
    # on the CPU every wrapper runs its plain version: no launches
    assert all(not any(s["launches"].values()) for s in stats)
    st = tp2.stats()
    assert st["backend"] == "gloo" and st["mesh"]["tp"] == 2
    block = tp2.model.layers[0]
    assert (block.heads, block.kv_heads) == (4, 2)        # of H=8, Hkv=4


# ---- the worker ------------------------------------------------------------

def test_worker_serves_tp2_and_unload_stops_the_follower():
    w = WorkerAgent(device="cpu")
    w.serve("127.0.0.1", 0, background=True)
    url = f"http://127.0.0.1:{w.service.port}"
    base = {"model_name": "tiny-llama", "allow_random_init": True,
            "dtype": "float32", "max_seq": 64}
    try:
        for extra in ({"mesh": {"tp": 2}, "serving": "batched",
                       "kv_host_mb": 8},
                      {"mesh": {"dp": 2}},
                      {"mesh": {"sp": 2}, "serving": "batched"},
                      {"mesh": {"tp": 3}},
                      {"mesh": {"tp": 2, "nope": 1}}):
            r = requests.post(url + "/load_model", json={**base, **extra},
                              timeout=60)
            assert r.status_code == 400, (extra, r.text)
        r = requests.post(url + "/load_model", json={
            **base, "mesh": {"tp": 2}, "quantize": "int4"}, timeout=120)
        assert r.status_code == 200, r.text
        assert r.json()["stats"]["backend"] == "gloo"
        [m] = requests.get(url + "/health", timeout=30).json()["loaded_models"]
        assert m["mesh"]["tp"] == 2 and m["backend"] == "gloo"
        pids = [p.pid for p in w.models["tiny-llama"].engine._leader.procs]
        assert len(pids) == 1
        body = {"model_name": "tiny-llama", "prompt_tokens": [5, 9, 13, 2],
                "max_new_tokens": 6, "seed": 3,
                "sampling": {"do_sample": False}}
        a = requests.post(url + "/inference", json=body, timeout=60).json()
        assert a["status"] == "success" and 1 <= len(a["tokens"]) <= 6
        r = requests.post(url + "/unload_model",
                          json={"model_name": "tiny-llama"}, timeout=120)
        assert r.status_code == 200
        for pid in pids:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
    finally:
        w.shutdown()


@pytest.mark.parametrize("quantize", [None, "int4"])
def test_worker_tp2_checkpoint_each_rank_reads_its_cut(quantize):
    """``checkpoint_path`` with ``"mesh": {"tp": 2}``: no tree goes to the
    follower (the engine passes it the checkpoint source, and each rank
    converts the files and keeps its cut of each tensor); greedy tokens
    equal the tp=1 load's."""
    from test_torch_convert import saved
    w = WorkerAgent(device="cpu")
    w.serve("127.0.0.1", 0, background=True)
    url = f"http://127.0.0.1:{w.service.port}"
    base = {"checkpoint_path": saved("llama"), "dtype": "float32",
            "max_seq": 64, **({"quantize": quantize} if quantize else {})}
    body = {"prompt_tokens": [5, 9, 13, 2, 40, 7], "max_new_tokens": 6,
            "seed": 3, "sampling": {"do_sample": False}}
    try:
        toks = {}
        for name, mesh in (("tp1", {}), ("tp2", {"tp": 2})):
            r = requests.post(url + "/load_model", json={
                **base, "model_name": name, "mesh": mesh}, timeout=180)
            assert r.status_code == 200, r.text
            a = requests.post(url + "/inference",
                              json={**body, "model_name": name},
                              timeout=120).json()
            assert a["status"] == "success", a
            toks[name] = a["tokens"]
        eng = w.models["tp2"].engine
        assert eng.group.world == 2
        assert eng.params["layers.0.q.scale" if quantize
                           else "layers.0.q.w"].shape[-1] == 32 // 2
        assert toks["tp2"] == toks["tp1"] and len(toks["tp1"]) == 6
    finally:
        for name in ("tp1", "tp2"):
            requests.post(url + "/unload_model", json={"model_name": name},
                          timeout=120)
        w.shutdown()
