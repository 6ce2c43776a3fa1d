"""Disaggregated prefill/decode with port workers, and KV transfer between
the port's and the JAX package's workers (CPU, tiny-llama f32).

One module-scoped fleet on localhost sockets, every worker serving the
same weights (the JAX init, bridged to the port bit for bit) in batched
mode over 8-token blocks: port workers in the prefill, decode and mixed
roles, and JAX workers in the prefill and decode roles. A disaggregated
request runs as the master runs it: a one-token ``kv_export`` pass on the
prefill worker, then the request on the decode worker with a
``kv_source`` naming the prefill worker. Held here:

- ``/role`` and ``/health`` (``role``, ``arena_occupancy``), as the JAX
  worker's;
- ``/kv_fetch``: the exported blocks' exact arena bytes, missing digests,
  validation (404, 400s, ``MAX_DIGESTS``) and the ``KV_FETCH_MAX_MB``
  cut;
- port to port: the decode worker's tokens from fetched KV equal a cold
  run's, greedy and sampled, with blocks transferred;
- across packages, both directions: a JAX prefill worker feeding a port
  decode worker, and a port prefill worker feeding a JAX decode worker;
  the decoding node's greedy tokens equal a cold run of its package;
- an int8 arena (``DLI_KV_HOST_DTYPE=int8``) on the prefill side: kvq8
  frames at under a third of the raw bytes, greedy tokens still equal;
- a batcher used directly pulls a request's ``kv_source`` itself, at
  admission, with its receive-overlapped restore (``DLI_KV_WIRE_OVERLAP``)
  on and off: the same blocks and a cold run's tokens;
- a cut fetch (an injected ``rpc:/kv_fetch`` fault, a dead peer, a peer
  without the model) costs a recompute: the request succeeds with a cold
  run's tokens, and ``kv_transfer_failures`` counts it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import requests

from distributed_llm_inferencing_tpu.models.params import (
    init_params as jax_init_params)
from distributed_llm_inferencing_tpu.models.registry import (
    get_config as jax_config)
from distributed_llm_inferencing_tpu.runtime.batcher import (
    ContinuousBatcher as JaxBatcher)
from distributed_llm_inferencing_tpu.runtime.worker import (
    LoadedModel as JaxLoadedModel, WorkerAgent as JaxWorkerAgent)
from distributed_llm_inferencing_tpu.utils.tokenizer import (
    load_tokenizer as jax_load_tokenizer)
from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.runtime import kvwire
from distributed_llm_inferencing_tpu_torch.runtime import worker as worker_mod
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.worker import (
    LoadedModel, WorkerAgent)
from distributed_llm_inferencing_tpu_torch.utils.tokenizer import (
    load_tokenizer)
from test_torch_families import one_torch_thread  # noqa: F401

MODEL = "tiny-llama"
# ~100 byte tokens: 12 full 8-token blocks, and room for 8 new in 128
LONG = "The quick brown fox jumps over the lazy dog. " * 2 + "Go."
POOL = dict(num_blocks=64, block_size=8, slots=4, max_seq=128)


class _Fleet:
    def __init__(self):
        jcfg = jax_config(MODEL).replace(dtype="float32")
        self.params = jax_init_params(jcfg, jax.random.PRNGKey(0))
        self.jcfg = jcfg.replace(attn_backend="xla")
        self.tcfg = ModelConfig(**dataclasses.asdict(jcfg))
        self.tparams = params_from_jax(
            jax.tree.map(np.asarray, self.params), self.tcfg, "cpu")
        self.agents = []

    def port(self, role):
        agent = WorkerAgent(device="cpu", role=role)
        b = ContinuousBatcher(self.tcfg, self.tparams, device="cpu",
                              metrics=agent.metrics,
                              kv_fetcher=agent.peer_client(), **POOL)
        b.start()
        agent.models[MODEL] = LoadedModel(
            None, load_tokenizer(None, self.tcfg.vocab_size), "test",
            batcher=b)
        return self._serve(agent)

    def jax(self, role):
        agent = JaxWorkerAgent(role=role)
        b = JaxBatcher(self.jcfg, self.params, metrics=agent.metrics,
                       kv_fetcher=agent.peer_client(), **POOL)
        b.start()
        agent.models[MODEL] = JaxLoadedModel(
            None, jax_load_tokenizer(None, self.jcfg.vocab_size), "test",
            batcher=b)
        return self._serve(agent)

    def _serve(self, agent):
        agent.serve("127.0.0.1", 0, background=True)
        self.agents.append(agent)
        return agent, f"http://127.0.0.1:{agent.service.port}"

    def close(self):
        for agent in self.agents:
            agent.service.shutdown()
            agent.models[MODEL].batcher.stop()


@pytest.fixture(scope="module")
def fleet():
    f = _Fleet()
    f.p_src, f.p_dst, f.p_cold = (f.port(r)
                                  for r in ("prefill", "decode", "mixed"))
    f.j_src, f.j_dst = (f.jax(r) for r in ("prefill", "decode"))
    yield f
    f.close()


def _infer(url, prompt, max_new=8, seed=11, sampled=False, **extra):
    body = {"model_name": MODEL, "prompt": prompt, "max_new_tokens": max_new,
            "seed": seed, "sampling": {"do_sample": sampled,
                                       "temperature": 0.8, "top_k": 20}}
    r = requests.post(url + "/inference", json=dict(body, **extra),
                      timeout=600)
    assert r.status_code == 200, r.text
    return r.json()


def _disagg(src, dst, prompt, **kw):
    """The master's two dispatches: the one-token export pass on ``src``,
    then the request on ``dst`` naming ``src`` as its ``kv_source``."""
    _infer(src[1], prompt, max_new=1, kv_export=True, **kw)
    return _infer(dst[1], prompt, **kw,
                  kv_source={"url": src[1], "model": MODEL})


def _counters(agent):
    return agent.metrics.snapshot()["counters"]


def _blocks(prompt):
    """Blocks of ``prompt`` a transfer restores: the full blocks before
    its last token (byte tokens)."""
    return (len(load_tokenizer(None, 256).encode(prompt)) - 1) // 8


def _digests(agent, prompt):
    b = agent.models[MODEL].batcher
    toks = agent.models[MODEL].tokenizer.encode(prompt)
    return b.kvtier.block_digests(toks[:len(toks) // 8 * 8])


def test_role_and_health(fleet):
    agent, url = fleet.p_src
    h = requests.get(url + "/health", timeout=30).json()
    assert h["role"] == "prefill" and h["arena_occupancy"] is not None
    _infer(url, "<h> " + LONG, max_new=1, kv_export=True)
    h = requests.get(url + "/health", timeout=30).json()
    assert 0 < h["arena_occupancy"] <= 1
    kv = h["loaded_models"][0]["scheduler"]["kvtier"]
    assert kv["occupancy"] == h["arena_occupancy"]
    try:
        r = requests.post(url + "/role", json={"role": "decode"}, timeout=30)
        assert r.json() == {"status": "success", "role": "decode",
                            "previous": "prefill"}
        assert requests.get(url + "/health", timeout=30).json()["role"] == \
            "decode"
        snap = agent.metrics.snapshot()
        assert snap["gauges"]["worker_role"] == 2.0
        assert snap["counters"]["role_flips"] == 1
        assert requests.post(url + "/role", json={"role": "gpu"},
                             timeout=30).status_code == 400
    finally:
        requests.post(url + "/role", json={"role": "prefill"}, timeout=30)
    with pytest.raises(ValueError):
        WorkerAgent(device="cpu", role="gpu")
    assert requests.get(fleet.p_cold[1] + "/health",
                        timeout=30).json()["role"] == "mixed"
    # a worker without a batched model reports no arena
    assert WorkerAgent(device="cpu").health({})["arena_occupancy"] is None


def test_kv_fetch_serves_the_exported_blocks(fleet):
    agent, url = fleet.p_src
    prompt = "<f> " + LONG
    _infer(url, prompt, max_new=1, kv_export=True)
    digs = _digests(agent, prompt)
    arena = agent.models[MODEL].batcher.kvtier.arena
    assert digs and all(arena.peek(d) for d in digs)
    r = requests.post(url + "/kv_fetch", json={
        "model_name": MODEL, "digests": digs + ["feedfacefeedface"]},
        stream=True, timeout=30)
    assert r.status_code == 200
    assert "octet-stream" in r.headers["Content-Type"]
    blocks, end = kvwire.decode_frames(r.iter_content(chunk_size=4096))
    assert set(blocks) == set(digs) and end["served"] == len(digs)
    assert end["missing"] == ["feedfacefeedface"] and end["truncated"] == 0
    for d in digs:
        for got, want in zip(blocks[d], arena.peek_pages(d)):
            assert got.tobytes() == want.tobytes()
    c = _counters(agent)
    assert c["kv_fetch_served_blocks"] >= len(digs)
    assert c["kv_wire_sent_bytes"] == c["kv_wire_raw_bytes"] > 0


def test_kv_fetch_validation_and_size_cap(fleet, monkeypatch):
    agent, url = fleet.p_src
    for body, code in (({"model_name": "nope", "digests": ["d"]}, 404),
                       ({"model_name": MODEL, "digests": []}, 400),
                       ({"model_name": MODEL, "digests": [1, 2]}, 400),
                       ({"model_name": MODEL,
                         "digests": ["d"] * (kvwire.MAX_DIGESTS + 1)}, 400)):
        assert requests.post(url + "/kv_fetch", json=body,
                             timeout=30).status_code == code
    prompt = "<c> " + LONG
    _infer(url, prompt, max_new=1, kv_export=True)
    digs = _digests(agent, prompt)
    arena = agent.models[MODEL].batcher.kvtier.arena
    one = len(kvwire.encode_stored(digs[0], arena.peek_stored(digs[0])))
    for cap_bytes, served in ((1, 0), (one, 1)):
        monkeypatch.setattr(worker_mod, "KV_FETCH_MAX_MB", cap_bytes / 2**20)
        r = requests.post(url + "/kv_fetch", json={
            "model_name": MODEL, "digests": digs}, stream=True, timeout=30)
        blocks, end = kvwire.decode_frames(r.iter_content(chunk_size=4096))
        assert len(blocks) == end["served"] == served
        assert end["served_bytes"] == served * one
        assert end["truncated"] == len(digs) - served


def test_port_transfer_equals_a_cold_run(fleet):
    dst = fleet.p_dst[0]
    client = dst.peer_client()
    for sampled, seed in ((False, 11), (True, 12)):
        prompt = f"<t{seed}> " + LONG
        ref = _infer(fleet.p_cold[1], prompt, seed=seed, sampled=sampled)
        before = _counters(dst)["kv_transfer_blocks"]
        got = _disagg(fleet.p_src, fleet.p_dst, prompt, seed=seed,
                      sampled=sampled)
        assert got["tokens"] == ref["tokens"] and \
            got["result"] == ref["result"]
        assert _counters(dst)["kv_transfer_blocks"] - before == \
            _blocks(prompt)
        assert got["cost"]["kv_transfer_bytes"] > 0
        assert got["cost"]["prefill_cached_tokens"] == 8 * _blocks(prompt)
    c = _counters(dst)
    # the second fetch rode the pooled keep-alive socket
    assert c["worker_peer_conns_created"] == 1
    assert c["worker_peer_conns_reused"] >= 1
    assert client is dst.peer_client()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_package_transfer(fleet, direction):
    prompt = f"<{direction}> " + LONG
    if direction == "jax_to_port":
        src, dst, cold = fleet.j_src, fleet.p_dst, fleet.p_cold
    else:
        # the JAX decode node's cold reference: a JAX node that never saw
        # the prompt (the JAX prefill worker, before this prompt's export)
        src, dst, cold = fleet.p_src, fleet.j_dst, fleet.j_src
    ref = _infer(cold[1], prompt)
    before = _counters(dst[0]).get("kv_transfer_blocks", 0)
    got = _disagg(src, dst, prompt)
    assert got["tokens"] == ref["tokens"]
    assert _counters(dst[0])["kv_transfer_blocks"] - before == \
        _blocks(prompt)
    assert _counters(dst[0]).get("kv_transfer_failures", 0) == 0
    assert got["cost"]["prefill_cached_tokens"] == 8 * _blocks(prompt)


def test_int8_arena_transfer(fleet, monkeypatch):
    monkeypatch.setenv("DLI_KV_HOST_DTYPE", "int8")
    src = fleet.port("prefill")
    assert src[0].models[MODEL].batcher.kvtier.arena.dtype == "int8"
    prompt = "<q8> " + LONG
    ref = _infer(fleet.p_cold[1], prompt, seed=31)
    before = dict(_counters(fleet.p_dst[0]))
    got = _disagg(src, fleet.p_dst, prompt, seed=31)
    assert got["tokens"] == ref["tokens"]
    sc, dc = _counters(src[0]), _counters(fleet.p_dst[0])
    assert 0 < sc["kv_wire_sent_bytes"] < sc["kv_wire_raw_bytes"] / 3
    assert dc["kv_transfer_blocks"] - before["kv_transfer_blocks"] == \
        _blocks(prompt)
    assert dc["kv_transfer_bytes"] - before["kv_transfer_bytes"] == \
        sc["kv_wire_sent_bytes"]
    assert dc["kv_transfer_failures"] == before["kv_transfer_failures"]


def test_batcher_pulls_its_kv_source_on_the_scheduler_thread(fleet):
    """A batcher used directly (no worker prefetch) fetches a request's
    ``kv_source`` at admission with its own fetch client."""
    prompt = "<direct> " + LONG
    ref = _infer(fleet.p_cold[1], prompt)
    _infer(fleet.p_src[1], prompt, max_new=1, kv_export=True)
    b = ContinuousBatcher(fleet.tcfg, fleet.tparams, device="cpu", **POOL)
    toks = load_tokenizer(None, fleet.tcfg.vocab_size).encode(prompt)
    req = b.submit(toks, max_new_tokens=8, seed=11,
                   sampling=SamplingParams.greedy(),
                   kv_source={"url": fleet.p_src[1], "model": MODEL})
    while not req.done.is_set():
        b.step()
    assert req.wait() == ref["tokens"]
    assert b.metrics.snapshot()["counters"]["kv_transfer_blocks"] == \
        _blocks(prompt)
    assert req.cost["kv_transfer_bytes"] > 0
    assert req.cost["prefill_cached_tokens"] == 8 * _blocks(prompt)
    b.kv_fetcher.close()


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "serial"])
def test_receive_overlapped_restore_equals_serial_and_cold(fleet, overlap):
    """The batcher's own ``kv_source`` fetch with the receive overlap on
    (runs of ``RESTORE_RUN`` landed blocks restored while later frames
    arrive: 12 blocks, so a run lands mid-stream) and off
    (``DLI_KV_WIRE_OVERLAP=0``: the whole fetch, then the restore): the
    same blocks restored and a cold run's tokens, greedy and sampled."""
    prompt = f"<overlap {overlap}> " + LONG[:90]
    toks = load_tokenizer(None, fleet.tcfg.vocab_size).encode(prompt)
    _infer(fleet.p_src[1], prompt, max_new=1, kv_export=True)
    b = ContinuousBatcher(fleet.tcfg, fleet.tparams, device="cpu", **POOL)
    b._wire_overlap = overlap
    assert b.RESTORE_RUN < _blocks(prompt)
    for sampled in (False, True):
        ref = _infer(fleet.p_cold[1], prompt, sampled=sampled)
        req = b.submit(toks, max_new_tokens=8, seed=11, sampling=(
            SamplingParams(temperature=0.8, top_k=20) if sampled
            else SamplingParams.greedy()),
            kv_source={"url": fleet.p_src[1], "model": MODEL})
        while not req.done.is_set():
            b.step()
        assert req.wait() == ref["tokens"], sampled
    m = b.metrics.snapshot()
    assert m["counters"]["kv_transfer_blocks"] == _blocks(prompt)
    assert m["counters"]["kvtier_restored_blocks"] == _blocks(prompt)
    assert (m["gauges"]["kv_restore_overlap_ratio"] > 0) == overlap
    b.kv_fetcher.close()


class _Faults:
    """An ``intercept(point)`` injector (the JAX package's interface):
    every ``rpc:/kv_fetch`` fails as a connection fault."""

    class _Fault:
        mode, delay_s = "error", 0.0

    def __init__(self):
        self.points = []

    def intercept(self, point):
        self.points.append(point)
        return self._Fault()


@pytest.mark.parametrize("cut", ["injected", "dead_peer", "no_model"])
def test_cut_fetch_degrades_to_recompute(fleet, monkeypatch, cut):
    dst = fleet.p_dst[0]
    prompt = f"<{cut}> " + LONG
    ref = _infer(fleet.p_cold[1], prompt, seed=5)
    _infer(fleet.p_src[1], prompt, max_new=1, seed=5, kv_export=True)
    url = fleet.p_src[1]
    faults = _Faults()
    if cut == "injected":
        monkeypatch.setattr(dst.peer_client(), "faults", faults)
    elif cut == "dead_peer":
        url = "http://127.0.0.1:1"
    else:
        url = fleet.p_cold[1]   # serves a model, but not under this name
    before = _counters(dst)
    got = _infer(fleet.p_dst[1], prompt, seed=5, kv_source={
        "url": url, "model": MODEL if cut != "no_model" else "other"})
    assert got["tokens"] == ref["tokens"]
    after = _counters(dst)
    assert after["kv_transfer_failures"] == \
        before["kv_transfer_failures"] + 1
    assert after["kv_transfer_blocks"] == before["kv_transfer_blocks"]
    assert got["cost"]["prefill_cached_tokens"] == 0
    assert faults.points == (["rpc:/kv_fetch"] if cut == "injected" else [])
