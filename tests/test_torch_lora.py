"""Multi-LoRA serving in the port against the JAX package (CPU, tiny-llama
f32, the JAX init bridged bit for bit; adapters from ``synth:`` sources
at scale 0.8, strong enough to flip greedy tokens).

- The pieces: ``gathered_delta`` within 1e-6 of the JAX one and
  ``merge_into_dense`` equal; ``synthesize`` and ``build_pack`` bitwise
  the JAX ones; a ``lora.npz`` directory read in both directions; the
  host store step by step against the JAX ``LoRAHostStore``.
- Serving, per base weight form (float, int8, int4): engine greedy tokens
  equal to the JAX engine's, base and under an adapter; a mixed wave
  (base rows, two adapters) equal to the JAX batcher's and to dedicated
  port batchers'.
- The JAX batcher's adapter-blind radix cache (ROADMAP Queue C): a
  25-token prompt served on base weights and then under an adapter gives
  the adapter run the JAX dedicated batcher's tokens here, because the
  port keys KV reuse by adapter.
- Failure semantics (tests/test_lora.py): an unknown adapter, a refused
  load, unload with live requests, slot exhaustion; a resume record that
  carries the adapter from a port batcher to a JAX one and back.
- The worker: ``/load_adapter`` and ``/unload_adapter`` codes, the
  ``/health`` advertisement in both modes, and ``adapter`` on
  ``/inference``.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import requests
import torch

from distributed_llm_inferencing_tpu.models import lora as jlora
from distributed_llm_inferencing_tpu.models.params import (
    init_params as jax_init_params)
from distributed_llm_inferencing_tpu.models.registry import (
    get_config as jax_config)
from distributed_llm_inferencing_tpu.ops import lora as jlora_ops
from distributed_llm_inferencing_tpu.ops.quant import quantize_params
from distributed_llm_inferencing_tpu.ops.sampling import (
    SamplingParams as JaxSamplingParams)
from distributed_llm_inferencing_tpu.runtime.batcher import (
    ContinuousBatcher as JaxBatcher)
from distributed_llm_inferencing_tpu.runtime.engine import (
    InferenceEngine as JaxEngine)
from distributed_llm_inferencing_tpu_torch.models import lora
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.models.registry import get_config
from distributed_llm_inferencing_tpu_torch.ops import lora as lora_ops
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from distributed_llm_inferencing_tpu_torch.runtime.worker import WorkerAgent
from test_torch_families import one_torch_thread  # noqa: F401

A_SRC = "synth:rank=4,seed=3,scale=0.8"
B_SRC = "synth:rank=8,seed=9,scale=0.8"
POOL = dict(num_blocks=128, block_size=8, slots=4, max_seq=96, seed=0)
FORMS = [None, "int8", "int4"]
GREEDY = SamplingParams.greedy()
JGREEDY = JaxSamplingParams.greedy()


def _prompt(i, n=7):
    return np.random.default_rng(100 + i).integers(0, 256, n).tolist()


@pytest.fixture(scope="module")
def trees():
    """form -> (JAX config, JAX params, port config, port params)."""
    base = jax_config("tiny-llama").replace(dtype="float32",
                                            attn_backend="xla")
    params = jax_init_params(base, jax.random.PRNGKey(0), dtype=jnp.float32)
    out = {}
    for q in FORMS:
        jcfg = base.replace(quant=q)
        jp = params if q is None else quantize_params(params, jcfg, mode=q)
        tcfg = get_config("tiny-llama").replace(dtype="float32", quant=q)
        out[q] = (jcfg, jp, tcfg,
                  params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    return out


def _port_batcher(trees, q=None, **kw):
    _, _, tcfg, tp = trees[q]
    b = ContinuousBatcher(tcfg, tp, device="cpu", **dict(POOL, **kw))
    b.DECODE_CHUNKS = (4,)
    return b


def _jax_batcher(trees, q=None, **kw):
    jcfg, jp, _, _ = trees[q]
    b = JaxBatcher(jcfg, jp, **dict(POOL, **kw))
    b.DECODE_CHUNKS = (4,)
    return b


def _drain(b, reqs, limit=400):
    for _ in range(limit):
        b.step()
        if all(r.done.is_set() for r in reqs):
            return reqs
    raise AssertionError("batcher did not drain")


def _serve(b, specs, sampling):
    """specs: (prompt, adapter, seed); tokens of each, one wave."""
    reqs = [b.submit(p, max_new_tokens=8, sampling=sampling, seed=s,
                     adapter=a) for p, a, s in specs]
    return [r.wait() for r in _drain(b, reqs)]


# ---- the pieces ------------------------------------------------------------

def test_gathered_delta_matches_jax():
    rng = np.random.default_rng(5)
    S, din, rmax, dout, B, T = 3, 8, 4, 6, 4, 3
    a = rng.standard_normal((S, din, rmax)).astype(np.float32)
    b = rng.standard_normal((S, rmax, dout)).astype(np.float32)
    a[0], b[0] = 0.0, 0.0
    x = rng.standard_normal((B, T, din)).astype(np.float32)
    ids = np.array([0, 1, 2, 1], np.int32)
    want = np.asarray(jlora_ops.gathered_delta(
        jnp.asarray(x), {"a": jnp.asarray(a), "b": jnp.asarray(b)},
        jnp.asarray(ids)))
    got = lora_ops.gathered_delta(
        torch.from_numpy(x), {"a": torch.from_numpy(a),
                              "b": torch.from_numpy(b)},
        torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.all(got[0] == 0.0)
    w = rng.standard_normal((din, dout)).astype(np.float32)
    np.testing.assert_allclose(
        lora_ops.merge_into_dense(torch.from_numpy(w), torch.from_numpy(
            a[1]), torch.from_numpy(b[1]), 0.5).numpy(),
        np.asarray(jlora_ops.merge_into_dense(w, a[1], b[1], 0.5)),
        rtol=0, atol=1e-6)


def test_synthesize_pack_and_npz_match_jax_bitwise(tmp_path):
    jcfg = jax_config("tiny-llama")
    tcfg = get_config("tiny-llama")
    mine = lora.synthesize(tcfg, "ad", rank=4, seed=3, scale=0.8)
    ref = jlora.synthesize(jcfg, "ad", rank=4, seed=3, scale=0.8)
    assert (mine.rank, mine.alpha, mine.targets, mine.nbytes) == \
        (ref.rank, ref.alpha, ref.targets, ref.nbytes)
    for lp, rp in zip(mine.layers, ref.layers):
        for t in lp:
            for x, y in zip(lp[t], rp[t]):
                assert x.dtype == y.dtype and np.array_equal(x, y)
    other = lora.resolve(tcfg, "b", B_SRC)
    pack = lora.build_pack(tcfg, [None, mine, None, other], 8)
    jpack = jlora.build_pack(jcfg, [None, ref, None,
                                    jlora.resolve(jcfg, "b", B_SRC)], 8)
    assert set(pack) == set(jpack)
    for t in pack:
        for k in ("a", "b"):
            assert np.array_equal(pack[t][k], jpack[t][k])
    # one slot's rows as the batcher writes them = the pack's
    a3, b3 = lora.slot_arrays(tcfg, other, "down", 1, 8)
    assert np.array_equal(a3, pack["down"]["a"][1, 3])
    assert np.array_equal(b3, pack["down"]["b"][1, 3])
    # lora.npz + lora_config.json, both directions
    lora.save_adapter(mine, str(tmp_path / "port"))
    jlora.save_adapter(ref, str(tmp_path / "jax"))
    back = jlora.load_adapter(jcfg, "x", str(tmp_path / "port"))
    fwd = lora.load_adapter(tcfg, "x", str(tmp_path / "jax"))
    for got in (back, fwd):
        assert (got.rank, got.alpha, got.targets) == \
            (ref.rank, ref.alpha, ref.targets)
        for lp, rp in zip(got.layers, ref.layers):
            assert all(np.array_equal(lp[t][i], rp[t][i])
                       for t in rp for i in (0, 1))


def test_host_store_matches_jax_step_by_step():
    tcfg, jcfg = get_config("tiny-llama"), jax_config("tiny-llama")
    ads = [(lora.synthesize(tcfg, f"ad{i}", rank=2, seed=i),
            jlora.synthesize(jcfg, f"ad{i}", rank=2, seed=i))
           for i in range(4)]
    per = ads[0][0].nbytes
    stores = (lora.LoRAHostStore(capacity_mb=2.5 * per / 2**20),
              jlora.LoRAHostStore(capacity_mb=2.5 * per / 2**20))

    def both(op):
        out = []
        for side, store in enumerate(stores):
            try:
                r = op(side, store)
                out.append(r if not hasattr(r, "name") else r.name)
            except ValueError as e:
                out.append(("ValueError", str(e)))
            out[-1] = (out[-1], store.stats(), sorted(store.names()))
        assert out[0] == out[1]
        return out[0][0]

    assert both(lambda s, st: st.put(ads[0][s])) == []
    assert both(lambda s, st: st.put(ads[1][s])) == []
    both(lambda s, st: st.get("ad0"))
    assert both(lambda s, st: st.put(ads[2][s])) == ["ad1"]
    assert both(lambda s, st: st.put(ads[3][s], pinned={"ad0", "ad2"}))[0] \
        == "ValueError"
    both(lambda s, st: st.get("ghost"))
    both(lambda s, st: st.get("ad2"))
    both(lambda s, st: st.peek("ad0"))
    assert both(lambda s, st: st.put(ads[3][s])) == ["ad0"]
    assert both(lambda s, st: st.drop("ad2")) is True
    assert both(lambda s, st: st.drop("ad2")) is False


def test_lora_refuses_moe_and_knobs_read_the_environment(monkeypatch):
    with pytest.raises(ValueError, match="MoE"):
        lora.validate_base_model(get_config("tiny-mixtral"))
    monkeypatch.setenv("DLI_LORA_SLOTS", "2")
    monkeypatch.setenv("DLI_LORA_MAX_RANK", "8")
    monkeypatch.setenv("DLI_LORA_HOST_MB", "1.5")
    assert (lora.slots_from_env(), lora.max_rank_from_env(),
            lora.host_mb_from_env()) == (jlora.slots_from_env(),
                                         jlora.max_rank_from_env(),
                                         jlora.host_mb_from_env()) \
        == (2, 8, 1.5)


# ---- serving against the JAX package --------------------------------------

@pytest.mark.parametrize("q", FORMS, ids=["float", "int8", "int4"])
def test_engine_adapter_tokens_match_jax_engine(trees, q):
    jcfg, jp, tcfg, tp = trees[q]
    jeng = JaxEngine(jcfg, jp, max_seq=96)
    teng = InferenceEngine(tcfg, tp, max_seq=96, device="cpu")
    for e in (jeng, teng):
        e.load_adapter(name="a1", source=A_SRC)
    prompts = [_prompt(0), _prompt(1, 14)]   # one prefill bucket
    # 5 new tokens: one 4-step decode program per tree on the JAX side
    for ad in (None, "a1"):
        want = jeng.generate(prompts, max_new_tokens=5, sampling=JGREEDY,
                             adapter=ad).tokens
        got = teng.generate(prompts, max_new_tokens=5, sampling=GREEDY,
                            adapter=ad).tokens
        assert got == want
        if ad is None:
            base = got
    assert got != base   # the adapter changes the tokens
    assert teng.adapter_stats()["resident"] == ["a1"]
    with pytest.raises(ValueError, match="unknown adapter"):
        teng.generate(prompts, max_new_tokens=2, adapter="ghost")
    with pytest.raises(ValueError, match="speculative"):
        teng.generate([prompts[0]], max_new_tokens=2, adapter="a1",
                      speculative="ngram")
    if q is not None:
        return
    # a reload under the same name replaces the pack and its programs
    teng.load_adapter(name="a1", source=B_SRC)
    jeng.load_adapter(name="a1", source=B_SRC)
    assert teng.generate(prompts, max_new_tokens=5, sampling=GREEDY,
                         adapter="a1").tokens == jeng.generate(
        prompts, max_new_tokens=5, sampling=JGREEDY, adapter="a1").tokens
    assert teng.unload_adapter("a1") and not teng.unload_adapter("a1")


def _mixed_specs():
    return [(_prompt(0, 20), "a1", 50), (_prompt(1, 9), None, 51),
            (_prompt(2, 13), "a2", 52), (_prompt(3, 7), "a1", 53)]


@pytest.mark.parametrize("q", FORMS, ids=["float", "int8", "int4"])
def test_mixed_wave_matches_jax_batcher_and_dedicated(trees, q):
    """A wave of base rows and two adapters: the JAX batcher's tokens,
    and per request a dedicated single-adapter port batcher's."""
    jb, tb = _jax_batcher(trees, q), _port_batcher(trees, q)
    for b in (jb, tb):
        b.load_adapter("a1", A_SRC)
        b.load_adapter("a2", B_SRC)
    specs = _mixed_specs()
    want = _serve(jb, specs, JGREEDY)
    got = _serve(tb, specs, GREEDY)
    assert got == want
    st = tb.lora_stats()
    assert st["resident"] == ["a1", "a2"] and not st["active_refs"]
    for name in ("a1", "a2", None):
        ded = _port_batcher(trees, q)
        if name:
            ded.load_adapter(name, A_SRC if name == "a1" else B_SRC)
        idx = [i for i, s in enumerate(specs) if s[1] == name]
        alone = _serve(ded, [specs[i] for i in idx], GREEDY)
        assert alone == [got[i] for i in idx]


def test_adapter_after_base_on_a_shared_prompt_gets_dedicated_tokens(trees):
    """The JAX batcher matches its radix cache by tokens alone, so its
    adapter request reuses the base run's KV (ROADMAP Queue C); the
    port's namespaces keep them apart and its tokens equal the JAX
    dedicated batcher's."""
    prompt = np.random.default_rng(7).integers(0, 256, 25).tolist()
    ded = _jax_batcher(trees)
    ded.load_adapter("a1", A_SRC)
    want = _serve(ded, [(prompt, "a1", 1)], JGREEDY)[0]
    tb = _port_batcher(trees)
    tb.load_adapter("a1", A_SRC)
    base = _serve(tb, [(prompt, None, 1)], GREEDY)[0]
    got = tb.submit(prompt, max_new_tokens=8, sampling=GREEDY, seed=1,
                    adapter="a1")
    _drain(tb, [got])
    assert got.tokens == want and got.tokens != base
    assert got.cost["prefill_cached_tokens"] == 0
    # a second adapter request shares the adapter's own blocks
    again = tb.submit(prompt, max_new_tokens=8, sampling=GREEDY, seed=1,
                      adapter="a1")
    _drain(tb, [again])
    assert again.tokens == want
    assert again.cost["prefill_cached_tokens"] == 24


def test_speculative_batcher_with_adapters_equals_plain(trees):
    """The speculative chunk's lora variant: greedy tokens of a wave mixing
    adapters equal the plain batcher's."""
    specs = _mixed_specs()
    out = []
    for spec in (None, "ngram"):
        b = _port_batcher(trees, speculative=spec, spec_gamma=3,
                          spec_adaptive=False)
        b.load_adapter("a1", A_SRC)
        b.load_adapter("a2", B_SRC)
        out.append(_serve(b, specs, GREEDY))
        if spec:
            assert b.stats()["spec_wave"]["dispatches"] > 0
    assert out[0] == out[1]


# ---- failure semantics ------------------------------------------------------

def test_unknown_adapter_and_refused_loads_fail_loudly(trees):
    b = _port_batcher(trees)
    with pytest.raises(ValueError, match="unknown adapter"):
        b.submit(_prompt(0), max_new_tokens=4, adapter="ghost")
    assert not b.queue
    with pytest.raises(ValueError, match="rank"):
        b.load_adapter("fat", "synth:rank=99,seed=1")
    with pytest.raises(ValueError, match="synth param"):
        b.load_adapter("typo", "synth:rnak=4")
    assert b.metrics.snapshot()["counters"]["lora_load_failures"] == 2
    with pytest.raises(ValueError, match="unknown adapter"):
        b.submit(_prompt(0), max_new_tokens=4, adapter="fat")
    # a batch with one bad sub pins nothing
    b.load_adapter("ok", A_SRC)
    with pytest.raises(ValueError):
        b.submit_many([dict(prompt=_prompt(1), adapter="ok"),
                       dict(prompt=_prompt(2), adapter="ghost")])
    assert not b.lora_stats()["active_refs"]
    r = b.submit(_prompt(2), max_new_tokens=4, sampling=GREEDY,
                 adapter="ok")
    with pytest.raises(ValueError, match="live requests"):
        b.unload_adapter("ok")
    _drain(b, [r])
    assert r.error is None and len(r.tokens) == 4
    assert b.unload_adapter("ok") is True and not b.unload_adapter("ok")
    # the base model still serves
    r = b.submit(_prompt(1), max_new_tokens=4, sampling=GREEDY, seed=1)
    _drain(b, [r])
    assert r.error is None and len(r.tokens) == 4


def test_slot_exhaustion_fails_admission(trees, monkeypatch):
    monkeypatch.setenv("DLI_LORA_SLOTS", "1")
    b = _port_batcher(trees)
    b.load_adapter("s1", A_SRC)
    b.load_adapter("s2", B_SRC)
    r1 = b.submit(_prompt(0), max_new_tokens=8, sampling=GREEDY,
                  adapter="s1")
    r2 = b.submit(_prompt(1), max_new_tokens=8, sampling=GREEDY,
                  adapter="s2")
    _drain(b, [r1, r2])
    assert r1.error is None and len(r1.tokens) == 8
    assert r2.error is not None and "slots" in r2.error
    assert r2.tokens == []
    # the slot frees with r1: s2 now evicts s1 in place and serves
    ded = _port_batcher(trees)
    ded.load_adapter("s2", B_SRC)
    r3 = b.submit(_prompt(1), max_new_tokens=8, sampling=GREEDY, seed=3,
                  adapter="s2")
    want = ded.submit(_prompt(1), max_new_tokens=8, sampling=GREEDY,
                      seed=3, adapter="s2")
    _drain(b, [r3])
    _drain(ded, [want])
    assert r3.tokens == want.tokens
    assert b.lora_stats()["slotted"] == ["s2"]


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_migration_resume_carries_the_adapter(trees, direction):
    mk = {"port": (_port_batcher, GREEDY), "jax": (_jax_batcher, JGREEDY)}
    src_name, dst_name = direction.split("_to_")
    src = mk[src_name][0](trees)
    dst = mk[dst_name][0](trees)
    whole = _port_batcher(trees)
    for b in (src, dst, whole):
        b.load_adapter("mig", A_SRC)
    req = src.submit(_prompt(3), max_new_tokens=12,
                     sampling=mk[src_name][1], seed=7, adapter="mig")
    for _ in range(100):
        src.step()
        if len(req.tokens) >= 4:
            break
    assert 4 <= len(req.tokens) < 12 and not req.done.is_set()
    req._migrate_requested = True
    for _ in range(20):
        src.step()
        if req.done.is_set():
            break
    rec = req.resume_record
    assert rec is not None and rec["adapter"] == "mig"
    cont = dst.submit(rec["prompt_tokens"],
                      max_new_tokens=rec["max_new_tokens"],
                      sampling=mk[dst_name][1], resume=rec)
    assert cont.adapter == "mig"
    _drain(dst, [cont])
    ref = whole.submit(_prompt(3), max_new_tokens=12, sampling=GREEDY,
                       seed=7, adapter="mig")
    _drain(whole, [ref])
    assert cont.tokens[:len(rec["tokens"])] == rec["tokens"]
    assert cont.tokens == ref.tokens


# ---- the worker -------------------------------------------------------------

@pytest.fixture(scope="module")
def url():
    agent = WorkerAgent(device="cpu")
    agent.serve("127.0.0.1", 0, background=True)
    yield f"http://127.0.0.1:{agent.service.port}"
    agent.shutdown()


@pytest.mark.parametrize("serving", ["engine", "batched"])
def test_worker_adapter_routes(url, serving):
    name = "tiny-llama"
    r = requests.post(url + "/load_model", json={
        "model_name": name, "allow_random_init": True, "dtype": "float32",
        "max_seq": 64, "serving": serving, "kv_blocks": 64,
        "kv_block_size": 8, "slots": 2}, timeout=60)
    assert r.status_code == 200, r.text
    post = lambda route, body: requests.post(url + route, json=body,  # noqa
                                             timeout=60)
    assert post("/load_adapter", {"model_name": name,
                                  "adapter": "a1"}).status_code == 400
    assert post("/load_adapter", {"model_name": "nope", "adapter": "a1",
                                  "source": A_SRC}).status_code == 404
    bad = post("/load_adapter", {"model_name": name, "adapter": "fat",
                                 "source": "synth:rank=99"})
    assert bad.status_code == 400 and "rank" in bad.json()["message"]
    ok = post("/load_adapter", {"model_name": name, "adapter": "a1",
                                "source": A_SRC})
    assert ok.status_code == 200 and ok.json()["rank"] == 4
    health = requests.get(url + "/health", timeout=30).json()
    [m] = [m for m in health["loaded_models"] if m["name"] == name]
    ads = m["adapters"] if serving == "engine" else \
        m["scheduler"]["adapters"]
    assert ads["resident"] == ["a1"]
    body = {"model_name": name, "prompt_tokens": _prompt(0),
            "max_new_tokens": 6, "sampling": {"do_sample": False}}
    base = post("/inference", body).json()["tokens"]
    with_a1 = post("/inference", dict(body, adapter="a1")).json()["tokens"]
    assert len(with_a1) == 6 and with_a1 != base
    ghost = post("/inference", dict(body, adapter="ghost"))
    assert ghost.status_code == 400 and "unknown adapter" in \
        ghost.json()["message"]
    assert post("/unload_adapter", {"model_name": name,
                                    "adapter": "a1"}).status_code == 200
    assert post("/unload_adapter", {"model_name": name,
                                    "adapter": "a1"}).status_code == 404
    assert post("/inference", dict(body, adapter="a1")).status_code == 400
    post("/unload_model", {"model_name": name})


def test_tp_engine_refuses_adapters():
    """The JAX engine lets XLA place an adapter's pack on its mesh; the
    port's tp ranks would need their cut (ROADMAP Queue A item 9.11)."""
    eng = InferenceEngine(get_config("tiny-llama").replace(dtype="float32"),
                          max_seq=32, device="cpu")
    eng.group = object()   # stands for a tp rank's group
    with pytest.raises(ValueError, match="tp"):
        eng.load_adapter(name="a1", source=A_SRC)


def test_adapter_directory_source(trees):
    """A ``lora.npz`` directory written by the JAX package serves the
    same tokens as its ``synth:`` source."""
    d = tempfile.mkdtemp(prefix="dli-lora-")
    jlora.save_adapter(jlora.resolve(trees[None][0], "a1", A_SRC), d)
    b1, b2 = _port_batcher(trees), _port_batcher(trees)
    b1.load_adapter("a1", A_SRC)
    b2.load_adapter("a1", d)
    specs = [(_prompt(0, 12), "a1", 5)]
    assert _serve(b1, specs, GREEDY) == _serve(b2, specs, GREEDY)
    assert os.path.isfile(os.path.join(d, "lora.npz"))
