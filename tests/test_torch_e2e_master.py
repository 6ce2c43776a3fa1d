"""The end-to-end gate: the unchanged master serving through a port worker.

The JAX package's ``Master`` runs in-process (as tests/test_migration.py
starts it) beside one JAX ``WorkerAgent`` and one port ``WorkerAgent``
(``device="cpu"``) on localhost sockets. Both serve tiny-llama f32 on the
same weights: the JAX tree is built once, and a model on it (the JAX
engine or batcher; the port's through ``params_from_jax``) goes into each
worker's ``models`` before ``/api/nodes/add``, so the master sees it on
``/health`` and never calls ``/load_model``. Then, through the master's
own API (``/api/inference/submit`` and ``/status``):

- engine mode, one node at a time: the port node's greedy result text
  equals the JAX node's for every prompt;
- batched mode, both nodes: requests submitted before the dispatcher
  starts are grouped into ``/inference_batch`` calls; every result equals
  the JAX engine's text for its prompt, each node serves some, and the
  port worker counts its batch calls;
- ``/api/cluster_metrics`` scrapes the port node's ``/metrics``, whose
  ``requests_completed`` counts the requests it served;
- ``/api/inference/cancel/<id>`` on a request in flight on the port node
  relays to its ``/cancel`` and frees the slot and its blocks;
- a request whose ``sampling`` names a ``checkpoint_path`` (an HF
  directory holding a tiny llama and a tiny tokenizer, nothing loaded
  yet): the master lazy-loads it on the node it routes to, and the port
  node's text equals the JAX node's, both encoding and decoding with the
  tokenizer found in the checkpoint directory;
- disaggregation: with a prefill-role and a decode-role port worker (the
  host KV arena on by default), a prompt of at least 256 characters
  takes the master's two-phase path (a one-token ``kv_export`` pass on
  the prefill node, then the request on the decode node with a
  ``kv_source``); the text equals the JAX engine's on the same weights,
  and the decode worker's counters show the blocks it fetched;
- live migration: the master's rebalancer drains a port worker whose
  request is mid-stream (its scheduler held step by step): it POSTs
  /migrate_out, the port dispatch answers 303 with the resume record,
  and the master re-dispatches it to a JAX node with the port worker as
  its ``kv_source``; the text equals an undisturbed JAX node's, no
  attempt is burned, and the JAX node fetched the port's blocks;
- multi-LoRA: an adapter registered on the master (``POST
  /api/adapters/register``, a ``synth:`` source) and named on submits:
  the master's dispatch lazy-loads it with ``/load_adapter`` on the port
  node (engine and batched), whose text equals a JAX node's and differs
  from the base model's;
- experts: tiny-mixtral through a port node, text equal to a JAX node's.

No latency is asserted; every wait polls with a deadline.
"""

import threading
import time

import jax
import numpy as np
import pytest
import requests

from distributed_llm_inferencing_tpu.models.params import (
    init_params as jax_init_params)
from distributed_llm_inferencing_tpu.models.registry import (
    get_config as jax_config)
from distributed_llm_inferencing_tpu.ops.sampling import (
    SamplingParams as JaxSamplingParams)
from distributed_llm_inferencing_tpu.runtime.batcher import (
    ContinuousBatcher as JaxBatcher)
from distributed_llm_inferencing_tpu.runtime.engine import (
    InferenceEngine as JaxEngine)
from distributed_llm_inferencing_tpu.runtime.master import Master
from distributed_llm_inferencing_tpu.runtime.worker import (
    LoadedModel as JaxLoadedModel, WorkerAgent as JaxWorkerAgent)
from distributed_llm_inferencing_tpu.utils.tokenizer import (
    load_tokenizer as jax_load_tokenizer)
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.models.registry import get_config
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from distributed_llm_inferencing_tpu_torch.runtime.worker import (
    LoadedModel, WorkerAgent)
from distributed_llm_inferencing_tpu_torch.utils.tokenizer import (
    load_tokenizer)
from test_torch_families import family_pair, one_torch_thread  # noqa: F401

MODEL = "tiny-llama"
MAX_SEQ = 128
PROMPTS = ["hello world", "the quick brown fox", "abc", "distributed llm"]
NEW = 12


def _cluster(model, jcfg, params, tcfg, tparams):
    """A JAX and a port worker serving ``model`` on the same weights
    (``params``, bridged as ``tparams``), and a maker of masters over
    them. Yields the cluster dict; stops everything after."""
    jax_agent, port_agent = JaxWorkerAgent(), WorkerAgent(device="cpu")
    for agent in (jax_agent, port_agent):
        agent.serve("127.0.0.1", 0, background=True)
    jax_agent.models[model] = JaxLoadedModel(
        JaxEngine(jcfg, params, max_seq=MAX_SEQ),
        jax_load_tokenizer(None, jcfg.vocab_size), "test")
    port_agent.models[model] = LoadedModel(
        InferenceEngine(tcfg, tparams, max_seq=MAX_SEQ, device="cpu"),
        load_tokenizer(None, tcfg.vocab_size), "test")

    def batched():
        """Swap each worker's engine for a batcher on the same weights."""
        jb = JaxBatcher(jcfg.replace(attn_backend="xla"), params,
                        num_blocks=128, block_size=8, slots=4,
                        max_seq=MAX_SEQ)
        tb = ContinuousBatcher(tcfg, tparams, num_blocks=128, block_size=8,
                               slots=4, max_seq=MAX_SEQ, device="cpu")
        for agent, b, lm in ((jax_agent, jb, JaxLoadedModel),
                             (port_agent, tb, LoadedModel)):
            b.start()
            agent.models[model] = lm(None, agent.models[model].tokenizer,
                                     "test", batcher=b)

    masters = []

    def master(**nodes):
        m = Master(":memory:", health_interval=0.5, disagg=False)
        srv = m.service.serve("127.0.0.1", 0, background=True)
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        ids = {}
        for name, agent in nodes.items():
            r = requests.post(f"{base}/api/nodes/add", json={
                "name": name, "host": "127.0.0.1",
                "port": agent.service.port}, timeout=30).json()
            assert r["status"] == "success", r
            ids[r["node_id"]] = name
        masters.append(m)
        return m, base, ids

    yield {"jax": jax_agent, "port": port_agent, "batched": batched,
           "master": master, "served": {}, "model": model}
    for m in masters:
        m.stop()
    jax_agent.service.shutdown()
    for agent in (jax_agent, port_agent):
        b = agent.models[model].batcher
        if b is not None:
            b.stop()
    port_agent.shutdown()


@pytest.fixture(scope="module")
def cluster():
    jcfg = jax_config(MODEL).replace(dtype="float32")
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = get_config(MODEL).replace(dtype="float32")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    yield from _cluster(MODEL, jcfg, params, tcfg, tparams)


@pytest.fixture(scope="module")
def gpt2_cluster():
    """tiny-gpt2, the reference's default family, on the weights of
    tests/test_torch_families.py (every bias and norm moved off its
    init)."""
    jcfg, params, tree, model = family_pair("tiny-gpt2")
    yield from _cluster("tiny-gpt2", jcfg, params, model.cfg,
                        params_from_jax(tree, model.cfg, "cpu"))


def _submit(base, prompt, new=NEW, model=MODEL):
    r = requests.post(f"{base}/api/inference/submit", json={
        "model_name": model, "prompt": prompt, "max_new_tokens": new,
        "sampling": {"do_sample": False}}, timeout=30).json()
    assert r["status"] == "success", r
    return r["request_id"]


def _row(base, rid):
    return requests.get(f"{base}/api/inference/status/{rid}",
                        timeout=30).json()["request"]


def _finish(base, rid, timeout=90.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        row = _row(base, rid)
        if row["status"] in ("completed", "failed"):
            return row
        time.sleep(0.05)
    raise AssertionError(f"request {rid} never finished")


def _wait(pred, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _serve_alone(cluster, side):
    """Every prompt through a master whose only node is ``side``'s."""
    m, base, _ = cluster["master"](**{side: cluster[side]})
    rids = [_submit(base, p, model=cluster["model"]) for p in PROMPTS]
    m.start_background()
    rows = [_finish(base, rid) for rid in rids]
    assert all(r["status"] == "completed" for r in rows), rows
    return [r["result"] for r in rows]


def _engine_mode(cluster):
    jax_texts = _serve_alone(cluster, "jax")
    port_texts = _serve_alone(cluster, "port")
    assert port_texts == jax_texts
    assert any(jax_texts)
    cluster["served"]["port"] = len(PROMPTS)
    cluster["reference"] = dict(zip(PROMPTS, jax_texts))


def test_engine_mode_port_node_equals_jax_node(cluster):
    _engine_mode(cluster)


def test_batched_mode_through_inference_batch(cluster):
    _batched_mode(cluster)


def test_gpt2_engine_mode_port_node_equals_jax_node(gpt2_cluster):
    """The reference's default family through the unchanged master: the
    port node's text equals the JAX node's."""
    _engine_mode(gpt2_cluster)


def test_gpt2_batched_mode_through_inference_batch(gpt2_cluster):
    _batched_mode(gpt2_cluster)


def _batched_mode(cluster):
    ref = cluster["reference"]
    cluster["batched"]()
    port = cluster["port"]
    batch_rpcs = port.metrics.snapshot()["counters"]["batch_rpcs"]
    m, base, ids = cluster["master"](jax=cluster["jax"], port=port)
    prompts = PROMPTS * 2
    rids = [_submit(base, p, model=cluster["model"])
            for p in prompts]                    # before the dispatcher
    m.start_background()
    rows = [_finish(base, rid) for rid in rids]
    assert all(r["status"] == "completed" for r in rows), rows
    for p, r in zip(prompts, rows):
        assert r["result"] == ref[p], (p, r)
    served = [ids[r["node_id"]] for r in rows]
    assert set(served) == {"jax", "port"}, served
    assert port.metrics.snapshot()["counters"]["batch_rpcs"] > batch_rpcs
    cluster["served"]["port"] += served.count("port")

    snap = requests.get(f"{base}/api/cluster_metrics", timeout=30).json()
    [node] = [n for n in snap["nodes"] if n["name"] == "port"]
    assert node["scraped"] is True, node
    assert node["counters"]["requests_completed"] == \
        cluster["served"]["port"]
    assert snap["cluster"]["workers_scraped"] == 2


class _Held:
    """Holds a batcher's scheduler thread: each step waits for a permit,
    so a request stays in flight for as long as the test needs it."""

    def __init__(self, batcher):
        self.batcher, self.steps = batcher, 0
        self._sem = threading.Semaphore(0)
        self._done = threading.Condition()
        step = batcher.step

        def held():
            self._sem.acquire()
            try:
                return step()
            finally:
                with self._done:
                    self.steps += 1
                    self._done.notify_all()

        batcher.step = held

    def allow(self):
        """Let one more step run and wait for it."""
        with self._done:
            want = self.steps + 1
            self._sem.release()
            assert self._done.wait_for(lambda: self.steps >= want, 60)

    def release(self):
        del self.batcher.step
        self._sem.release(1000)


def test_cancel_through_the_master_frees_the_port_slot(cluster):
    port = cluster["port"]
    b = port.models[MODEL].batcher
    assert b is not None, "runs after the batched test"
    free0 = b.stats()["blocks_free"]
    m, base, _ = cluster["master"](port=port)
    held = _Held(b)
    try:
        # "abc": 4 prompt tokens, no whole block left in the prefix cache
        rid = _submit(base, "abc", new=100)
        m.start_background()
        tag = m._tag(rid)
        _wait(lambda: tag in port._tagged, "the dispatch on the port node")
        req = port._tagged[tag]
        for _ in range(8):
            if req.tokens:
                break
            held.allow()
        assert req.tokens and b.stats()["active"] == 1
        c = requests.post(f"{base}/api/inference/cancel/{rid}", timeout=30)
        assert c.status_code == 200 and "relayed" in c.json()["message"], \
            c.text
        held.allow()              # the next step drops the slot
        assert req.done.is_set() and b.stats()["active"] == 0
        assert b.stats()["blocks_free"] == free0
    finally:
        held.release()
    row = _finish(base, rid)
    assert row["status"] == "failed" and "cancel" in row["error"], row
    assert port.metrics.snapshot()["counters"]["requests_cancelled"] == 1


@pytest.fixture
def port_worker():
    agent = WorkerAgent(device="cpu")
    agent.serve("127.0.0.1", 0, background=True)
    yield f"http://127.0.0.1:{agent.service.port}", agent
    for m in list(agent.models.values()):
        m.close()
    agent.shutdown()


_TINY_LOAD = {"model_name": "tiny-gpt2", "allow_random_init": True,
              "dtype": "float32", "max_seq": 64}


@pytest.mark.parametrize("serving,quant", [
    ("engine", None), ("engine", "int8"), ("engine", "int4"),
    ("batched", None), ("batched", "int8"), ("batched", "int4")])
def test_load_model_serves_tiny_gpt2(port_worker, serving, quant):
    """/load_model takes a family's registry name in every weight form and
    in both serving modes; /inference then answers."""
    base, agent = port_worker
    body = dict(_TINY_LOAD, serving=serving,
                **({"quantize": quant} if quant else {}))
    if serving == "batched":
        body.update(kv_blocks=32, kv_block_size=8, slots=2)
    r = requests.post(f"{base}/load_model", json=body, timeout=60)
    assert r.status_code == 200, r.text
    r = requests.post(f"{base}/inference", json={
        "model_name": "tiny-gpt2", "prompt": "hello", "max_new_tokens": 4,
        "sampling": {"do_sample": False}}, timeout=60).json()
    assert r["status"] == "success" and len(r["tokens"]) == 4, r
    health = requests.get(f"{base}/health", timeout=30).json()
    [desc] = health["loaded_models"]
    assert desc["quantize"] == quant


def test_load_model_refusals(port_worker, monkeypatch):
    """An ep that does not divide the experts is a 400 naming them (the
    JAX package's rule); a config outside the served choices (the JAX
    package's all-to-all expert dispatch) is a 400 from the construction
    check; an unknown name a 400."""
    base, agent = port_worker
    from distributed_llm_inferencing_tpu_torch.models import registry
    style = registry.get_config("tiny-mixtral").replace(
        name="tiny-mixtral-all-to-all", moe_dispatch="all_to_all")
    monkeypatch.setitem(registry._REGISTRY, style.name, style)
    for body, needle in (
            (dict(_TINY_LOAD, model_name="tiny-mixtral", mesh={"ep": 3}),
             "num_experts"),
            (dict(_TINY_LOAD, model_name=style.name), "moe_dispatch"),
            (dict(_TINY_LOAD, model_name="gemma2-9b"), "unknown model")):
        r = requests.post(f"{base}/load_model", json=body, timeout=60)
        assert r.status_code == 400 and needle in r.json()["message"], r.text
    assert not agent.models


def test_checkpoint_path_lazy_load_port_node_equals_jax_node():
    """The master forwards a request's ``checkpoint_path`` on its lazy
    /load_model (no dtype: both workers serve the checkpoint in bf16);
    each node serves the prompts alone; the texts are equal."""
    from test_torch_convert import with_tokenizer
    ckpt = with_tokenizer("llama")
    jax_agent, port_agent = JaxWorkerAgent(), WorkerAgent(device="cpu")
    for agent in (jax_agent, port_agent):
        agent.serve("127.0.0.1", 0, background=True)
    masters, texts = [], {}
    try:
        for side, agent in (("jax", jax_agent), ("port", port_agent)):
            m = Master(":memory:", health_interval=0.5, disagg=False)
            masters.append(m)
            srv = m.service.serve("127.0.0.1", 0, background=True)
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            r = requests.post(f"{base}/api/nodes/add", json={
                "name": side, "host": "127.0.0.1",
                "port": agent.service.port}, timeout=30).json()
            assert r["status"] == "success", r
            rids = []
            for p in PROMPTS:
                r = requests.post(f"{base}/api/inference/submit", json={
                    "model_name": "ckpt-llama", "prompt": p,
                    "max_new_tokens": 8, "sampling": {
                        "do_sample": False, "checkpoint_path": ckpt}},
                    timeout=30).json()
                assert r["status"] == "success", r
                rids.append(r["request_id"])
            m.start_background()
            rows = [_finish(base, rid, timeout=180) for rid in rids]
            assert all(r["status"] == "completed" for r in rows), rows
            texts[side] = [r["result"] for r in rows]
        assert texts["port"] == texts["jax"] and any(texts["jax"])
        [m] = requests.get(f"http://127.0.0.1:{port_agent.service.port}"
                           "/health", timeout=30).json()["loaded_models"]
        assert m["source"] == ckpt
        tok = port_agent.models["ckpt-llama"].tokenizer
        assert tok.encode(PROMPTS[0]) == \
            jax_agent.models["ckpt-llama"].tokenizer.encode(PROMPTS[0])
        assert type(tok).__name__ == "HFTokenizer"
    finally:
        for m in masters:
            m.stop()
        jax_agent.service.shutdown()
        port_agent.shutdown()


def test_disaggregated_prompt_through_the_master():
    """The unchanged master splits a long prompt across a prefill-role
    and a decode-role port worker; the decode worker fetches the prompt's
    KV over /kv_fetch and answers the JAX engine's text."""
    model = "tiny-llama-long"     # 1k positions: room for a long prompt
    jcfg = jax_config(model).replace(dtype="float32")
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = get_config(model).replace(dtype="float32")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    prompt = ("The quick brown fox jumps over the lazy dog. " * 6)[:264]
    assert len(prompt) >= 256
    tok = jax_load_tokenizer(None, jcfg.vocab_size)
    ref = tok.decode(JaxEngine(jcfg, params, max_seq=320).generate(
        [tok.encode(prompt)], max_new_tokens=NEW,
        sampling=JaxSamplingParams.greedy()).tokens[0])
    agents = {}
    for role in ("prefill", "decode"):
        agent = agents[role] = WorkerAgent(device="cpu", role=role)
        b = ContinuousBatcher(tcfg, tparams, num_blocks=96, block_size=8,
                              slots=2, max_seq=320, device="cpu",
                              metrics=agent.metrics,
                              kv_fetcher=agent.peer_client())
        b.start()
        agent.models[model] = LoadedModel(
            None, load_tokenizer(None, tcfg.vocab_size), "test", batcher=b)
        agent.serve("127.0.0.1", 0, background=True)
    m = Master(":memory:", health_interval=0.5, disagg=True)
    try:
        srv = m.service.serve("127.0.0.1", 0, background=True)
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        ids = {}
        for role, agent in agents.items():
            r = requests.post(f"{base}/api/nodes/add", json={
                "name": role, "host": "127.0.0.1",
                "port": agent.service.port}, timeout=30).json()
            assert r["status"] == "success", r
            ids[r["node_id"]] = role
        rid = _submit(base, prompt, model=model)
        m.start_background()
        row = _finish(base, rid)
        assert row["status"] == "completed", row
        assert row["result"] == ref and ids[row["node_id"]] == "decode"
        counters = {role: a.metrics.snapshot()["counters"]
                    for role, a in agents.items()}
        n = len(tok.encode(prompt))
        assert counters["decode"]["kv_transfer_blocks"] == (n - 1) // 8
        assert counters["decode"]["kv_transfer_failures"] == 0
        assert counters["prefill"]["kv_fetch_served_blocks"] == (n - 1) // 8
        assert counters["prefill"]["kvtier_exported_blocks"] == n // 8
    finally:
        m.stop()
        for agent in agents.values():
            agent.shutdown()


def test_master_drains_a_port_worker_mid_stream():
    """The unchanged master's rebalancer migrates a port worker's
    in-flight request off it when it drains: the resume lands on a JAX
    node, which fetches the port's exported KV, and the text equals the
    JAX engine's undisturbed text on the same weights."""
    jcfg = jax_config(MODEL).replace(dtype="float32")
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = get_config(MODEL).replace(dtype="float32")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    prompt, new = "please continue the story", 60
    tok = jax_load_tokenizer(None, jcfg.vocab_size)
    ref = tok.decode(JaxEngine(jcfg, params, max_seq=MAX_SEQ).generate(
        [tok.encode(prompt)], max_new_tokens=new,
        sampling=JaxSamplingParams.greedy()).tokens[0])
    port, jax_agent = WorkerAgent(device="cpu"), JaxWorkerAgent()
    pb = ContinuousBatcher(tcfg, tparams, num_blocks=64, block_size=8,
                           slots=2, max_seq=MAX_SEQ, device="cpu",
                           metrics=port.metrics)
    jb = JaxBatcher(jcfg.replace(attn_backend="xla"), params, num_blocks=64,
                    block_size=8, slots=2, max_seq=MAX_SEQ,
                    metrics=jax_agent.metrics,
                    kv_fetcher=jax_agent.peer_client())
    for agent, b, lm, load in ((port, pb, LoadedModel, load_tokenizer),
                               (jax_agent, jb, JaxLoadedModel,
                                jax_load_tokenizer)):
        b.DECODE_CHUNKS = (4,)
        b.start()
        agent.models[MODEL] = lm(None, load(None, jcfg.vocab_size), "test",
                                 batcher=b)
        agent.serve("127.0.0.1", 0, background=True)
    m = Master(":memory:", health_interval=0.1, disagg=False,
               rebalance=True, rebalance_interval_s=0.05,
               rebalance_sustain_s=0.5)
    held = _Held(pb)
    try:
        srv = m.service.serve("127.0.0.1", 0, background=True)
        base = f"http://127.0.0.1:{srv.server_address[1]}"

        def add(name, agent):
            r = requests.post(f"{base}/api/nodes/add", json={
                "name": name, "host": "127.0.0.1",
                "port": agent.service.port}, timeout=30).json()
            assert r["status"] == "success", r

        add("port", port)          # the only node: the request lands here
        rid = _submit(base, prompt, new=new)
        m.start_background()
        tag = m._tag(rid)
        _wait(lambda: tag in port._tagged, "the dispatch on the port node")
        req = port._tagged[tag]
        while len(req.tokens) < 8:
            held.allow()
        add("jax", jax_agent)
        threading.Thread(target=lambda: requests.post(
            f"http://127.0.0.1:{port.service.port}/drain",
            json={"timeout": 30}, timeout=60), daemon=True).start()
        _wait(lambda: req._migrate_requested, "the rebalancer's migrate_out")
        held.allow()               # the step that services the migration
        row = _finish(base, rid)
        assert row["status"] == "completed", row
        assert row["result"] == ref and row["attempts"] == 0
        assert req._migrated and len(req.resume_record["tokens"]) >= 8
        assert port.metrics.snapshot()["counters"][
            "requests_migrated_out"] == 1
        assert m.metrics.snapshot()["counters"]["requests_migrated"] == 1
        assert jax_agent.metrics.snapshot()["counters"][
            "kv_transfer_blocks"] > 0
    finally:
        held.release()
        m.stop()
        for agent in (port, jax_agent):
            agent.service.shutdown()
            agent.models[MODEL].batcher.stop()


def _side_by_side(model, jcfg, params, tcfg, tparams, bodies,
                  batched=False, register=None):
    """Each side's worker serving ``model`` on the same weights, behind a
    master of its own: the result texts of ``bodies`` submitted to each
    master (``register``: adapter -> source, registered first), and the
    port worker."""
    texts, masters = {}, []
    jax_agent, port_agent = JaxWorkerAgent(), WorkerAgent(device="cpu")
    pool = dict(num_blocks=64, block_size=8, slots=4, max_seq=MAX_SEQ)
    if batched:
        jb = JaxBatcher(jcfg.replace(attn_backend="xla"), params, **pool)
        tb = ContinuousBatcher(tcfg, tparams, device="cpu", **pool)
        for b in (jb, tb):
            b.start()
        jax_agent.models[model] = JaxLoadedModel(
            None, jax_load_tokenizer(None, jcfg.vocab_size), "test",
            batcher=jb)
        port_agent.models[model] = LoadedModel(
            None, load_tokenizer(None, tcfg.vocab_size), "test", batcher=tb)
    else:
        jax_agent.models[model] = JaxLoadedModel(
            JaxEngine(jcfg, params, max_seq=MAX_SEQ),
            jax_load_tokenizer(None, jcfg.vocab_size), "test")
        port_agent.models[model] = LoadedModel(
            InferenceEngine(tcfg, tparams, max_seq=MAX_SEQ, device="cpu"),
            load_tokenizer(None, tcfg.vocab_size), "test")
    try:
        for side, agent in (("jax", jax_agent), ("port", port_agent)):
            agent.serve("127.0.0.1", 0, background=True)
            m = Master(":memory:", health_interval=0.5, disagg=False)
            masters.append(m)
            srv = m.service.serve("127.0.0.1", 0, background=True)
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            r = requests.post(f"{base}/api/nodes/add", json={
                "name": side, "host": "127.0.0.1",
                "port": agent.service.port}, timeout=30).json()
            assert r["status"] == "success", r
            for name, src in (register or {}).items():
                r = requests.post(f"{base}/api/adapters/register", json={
                    "adapter": name, "source": src, "model_name": model},
                    timeout=30).json()
                assert r["status"] == "success", r
            rids = []
            for body in bodies:
                r = requests.post(f"{base}/api/inference/submit",
                                  json=dict(body, model_name=model),
                                  timeout=30).json()
                assert r["status"] == "success", r
                rids.append(r["request_id"])
            m.start_background()
            rows = [_finish(base, rid, timeout=120) for rid in rids]
            assert all(r["status"] == "completed" for r in rows), rows
            texts[side] = [r["result"] for r in rows]
        return texts, port_agent
    finally:
        for m in masters:
            m.stop()
        jax_agent.service.shutdown()
        for agent in (jax_agent, port_agent):
            b = agent.models[model].batcher
            if b is not None:
                b.stop()
        port_agent.shutdown()


@pytest.mark.parametrize("batched", [False, True],
                         ids=["engine", "batched"])
def test_adapter_lazy_loaded_by_the_master_on_a_port_node(batched):
    jcfg = jax_config(MODEL).replace(dtype="float32")
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = get_config(MODEL).replace(dtype="float32")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    greedy = {"max_new_tokens": 8, "sampling": {"do_sample": False}}
    # the base row's prompt shares no full block with the adapter rows':
    # the JAX batcher's radix cache is adapter-blind (ROADMAP Queue C)
    bodies = [dict(greedy, prompt=p, adapter="tenant-a")
              for p in PROMPTS[:2]]
    bodies.append(dict(greedy, prompt=PROMPTS[2]))
    texts, port = _side_by_side(
        MODEL, jcfg, params, tcfg, tparams, bodies, batched=batched,
        register={"tenant-a": "synth:rank=4,seed=3,scale=0.8"})
    assert texts["port"] == texts["jax"]
    tok = jax_load_tokenizer(None, jcfg.vocab_size)
    base = tok.decode(JaxEngine(jcfg, params, max_seq=MAX_SEQ).generate(
        [tok.encode(PROMPTS[0])], max_new_tokens=8,
        sampling=JaxSamplingParams.greedy()).tokens[0])
    assert texts["port"][0] != base   # the adapter bites
    lm = port.models[MODEL]
    stats = (lm.batcher.lora_stats() if batched
             else lm.engine.adapter_stats())
    assert stats["resident"] == ["tenant-a"]


def test_tiny_mixtral_through_a_port_node():
    jcfg = jax_config("tiny-mixtral").replace(dtype="float32")
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = get_config("tiny-mixtral").replace(dtype="float32")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    bodies = [{"prompt": p + " " + p, "max_new_tokens": 8,
               "sampling": {"do_sample": False}} for p in PROMPTS[:2]]
    texts, _ = _side_by_side("tiny-mixtral", jcfg, params, tcfg, tparams,
                             bodies)
    assert texts["port"] == texts["jax"] and any(texts["jax"])
