"""The port worker's control surface, held to the JAX worker's, on the CPU.

One JAX ``WorkerAgent`` and one port ``WorkerAgent`` (``device="cpu"``)
per serving mode, each serving tiny-llama f32 on the same weights (the
JAX tree, bridged with ``params_from_jax``) on a localhost socket. The
same calls go to both and must get the same answers:

- ``Metrics.prometheus()``: identical text (and ``snapshot()``) for the
  same sequence of ``inc``/``gauge``/``observe``/``time`` calls;
- ``request_tag``: replay (``idempotent: true``, no second generation),
  a duplicate joining the execution in flight, the 408 ``in_flight``
  join past the budget;
- ``/cancel``: 400 / 404 / 200, the batched slot and its blocks freed;
- ``/drain`` and ``/undrain`` with a request in flight;
- ``/inference_batch``: one line per sub-request, a sub-request's own
  400 beside its siblings' 200s, the size cap, ``submit_many`` order;
- ``/inference_stream``: event kinds and token ids, engine and batched;
  a bad body is a 400;
- auth (401 without the bearer token) and lease fencing (409 with
  ``X-DLI-Stale-Term`` for a stale master term);
- the engine's ``stream_cb``: the same tokens as ``generate`` without
  it, with and without eos, against the JAX engine's callback, and at
  tp=2 over gloo with the same per-rank collective counts.
"""

import json
import threading
import time
import types

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
from distributed_llm_inferencing_tpu.runtime import worker as jax_worker
from distributed_llm_inferencing_tpu.runtime.worker import (
    LoadedModel as JaxLoadedModel, WorkerAgent as JaxWorkerAgent)
from distributed_llm_inferencing_tpu.utils import metrics as jax_metrics
from distributed_llm_inferencing_tpu.utils.tokenizer import (
    load_tokenizer as jax_load_tokenizer)
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.models.registry import get_config
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.parallel.mesh import MeshSpec
from distributed_llm_inferencing_tpu_torch.runtime import worker as port_worker
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from distributed_llm_inferencing_tpu_torch.runtime.worker import (
    LoadedModel, WorkerAgent)
from distributed_llm_inferencing_tpu_torch.utils import metrics as port_metrics
from distributed_llm_inferencing_tpu_torch.utils.tokenizer import (
    load_tokenizer)
from test_torch_families import one_torch_thread  # noqa: F401

MODEL = "tiny-llama"
SIDES = ("jax", "port")
MAX_SEQ = 128       # tiny-llama's context window
PROMPTS = [[3, 17, 52, 9, 30], [5, 6, 7, 8, 9, 10, 11], [40, 41, 42]]
LONG = 120          # new tokens: no eos among PROMPTS' greedy 120


# ---- Metrics.prometheus(): the same text for the same calls --------------

def _collisions(m):
    # the cases of tests/test_metrics_exposition.py: dots, dashes and
    # spaces sanitize; a counter and a gauge share a registry name
    m.inc("requests.completed-ok", 3)
    m.gauge("requests.completed-ok", 7)
    m.inc("tokens_generated", 120)
    m.gauge("queue depth", 4)
    for v in (0.002, 0.004, 0.03, 0.3, 2.0, 80.0):
        m.observe("load model", v)


def _awkward(m):
    m.inc("9lives")
    m.inc("9lives", 0.5)
    m.gauge("a.b-c d", -1.25)
    m.gauge("big", 1e16)
    m.inc("zero", 0)
    m.observe("edge", 0.001)
    m.observe("edge", 300.0)
    m.observe("edge", 1e4)


def _timed(m):
    for name in ("inference", "inference", "load_model"):
        with m.time(name):
            pass
    m.inc("requests_completed", 2)


@pytest.mark.parametrize("calls", [_collisions, _awkward, _timed],
                         ids=["collisions", "awkward", "time"])
def test_prometheus_text_equals_jax(calls, monkeypatch):
    for mod in (port_metrics, jax_metrics):   # one fake clock each
        ticks = iter(np.arange(0.0, 100.0, 0.0375).tolist())
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=lambda ticks=ticks: next(ticks)))
    mine, ref = port_metrics.Metrics(), jax_metrics.Metrics()
    calls(ref)
    calls(mine)
    assert mine.prometheus() == ref.prometheus()
    assert mine.snapshot() == ref.snapshot()
    assert port_metrics.HIST_BUCKETS == jax_metrics.HIST_BUCKETS
    for name in ("a.b-c d", "9lives", "", "ok_name:x"):
        assert (port_metrics.sanitize_name(name)
                == jax_metrics.sanitize_name(name))


# ---- the two workers ------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config(MODEL).replace(dtype="float32")
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = get_config(MODEL).replace(dtype="float32")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, params, tcfg, tparams


def _model(side, mode, w):
    jcfg, params, tcfg, tparams = w
    if side == "jax":
        tok = jax_load_tokenizer(None, jcfg.vocab_size)
        if mode == "engine":
            return JaxLoadedModel(JaxEngine(jcfg, params, max_seq=MAX_SEQ),
                                  tok, "test")
        b = JaxBatcher(jcfg.replace(attn_backend="xla"), params,
                       num_blocks=128, block_size=8, slots=4,
                       max_seq=MAX_SEQ)
        b.start()
        return JaxLoadedModel(None, tok, "test", batcher=b)
    tok = load_tokenizer(None, tcfg.vocab_size)
    if mode == "engine":
        return LoadedModel(InferenceEngine(tcfg, tparams, max_seq=MAX_SEQ,
                                           device="cpu"), tok, "test")
    b = ContinuousBatcher(tcfg, tparams, num_blocks=128, block_size=8,
                          slots=4, max_seq=MAX_SEQ, device="cpu")
    b.start()
    return LoadedModel(None, tok, "test", batcher=b)


def _agent(side, auth_key=None):
    agent = (JaxWorkerAgent(auth_key=auth_key) if side == "jax"
             else WorkerAgent(device="cpu", auth_key=auth_key))
    agent.serve("127.0.0.1", 0, background=True)
    return agent


def _stop(agent):
    if isinstance(agent, WorkerAgent):
        agent.shutdown()
        return
    agent.service.shutdown()
    for m in agent.models.values():
        if m.batcher is not None:
            m.batcher.stop()


@pytest.fixture(scope="module")
def workers(weights):
    """{(side, mode): agent}, each agent built on first use."""
    made = {}

    def get(side, mode):
        if (side, mode) not in made:
            agent = _agent(side)
            agent.models[MODEL] = _model(side, mode, weights)
            made[side, mode] = agent
        return made[side, mode]

    yield get
    for agent in made.values():
        _stop(agent)


def _url(agent, path):
    return f"http://127.0.0.1:{agent.service.port}{path}"


def _body(prompt, new=8, **kw):
    return {"model_name": MODEL, "prompt_tokens": prompt,
            "max_new_tokens": new, "seed": 7,
            "sampling": {"do_sample": False}, **kw}


def _post(agent, path, body, **kw):
    return requests.post(_url(agent, path), json=body,
                         timeout=kw.pop("timeout", 120), **kw)


def _counter(agent, name):
    return agent.metrics.snapshot()["counters"].get(name, 0)


def _wait(pred, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _in_flight(agent, tag):
    with agent._tagged_lock:
        return agent._tagged.get(tag)


class _Held:
    """Holds a batcher's scheduler thread: each step waits for a permit
    (``allow``), so a request stays in flight for as long as a test needs
    it, whatever the speed of the host."""

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

    def allow(self, n=1):
        """Let ``n`` more steps run and wait for them."""
        with self._done:
            want = self.steps + n
            for _ in range(n):
                self._sem.release()
            assert self._done.wait_for(lambda: self.steps >= want, 60)

    def release(self):
        del self.batcher.step
        self._sem.release(1000)


def _running(agent, tag, held):
    """Step the held scheduler until the tagged request holds a slot and
    has emitted tokens; returns it."""
    _wait(lambda: _in_flight(agent, tag), "the request in flight")
    req = _in_flight(agent, tag)
    for _ in range(8):
        if req.tokens:
            return req
        held.allow()
    raise AssertionError("the request never started")


def _scheduler(agent):
    [m] = requests.get(_url(agent, "/health"), timeout=30).json()[
        "loaded_models"]
    return m["scheduler"]


# ---- request_tag: replay and join -----------------------------------------

@pytest.mark.parametrize("mode", ["engine", "batched"])
def test_request_tag_replay_runs_once(workers, mode):
    got = {}
    for side in SIDES:
        agent = workers(side, mode)
        body = _body(PROMPTS[0], request_tag=f"replay-{mode}")
        n0 = _counter(agent, "requests_completed")
        a = _post(agent, "/inference", body)
        b = _post(agent, "/inference", body)
        assert a.status_code == b.status_code == 200, (a.text, b.text)
        a, b = a.json(), b.json()
        assert "idempotent" not in a and b["idempotent"] is True
        assert b["tokens"] == a["tokens"] and b["result"] == a["result"]
        assert _counter(agent, "requests_completed") - n0 == 1
        assert _counter(agent, "idempotent_hits") >= 1
        got[side] = a["tokens"]
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("side", SIDES)
def test_duplicate_in_flight_joins_and_the_join_times_out(workers, side):
    agent = workers(side, "batched")
    tag = "join-1"
    kind, ev = agent._idem_claim(tag)          # an execution "in flight"
    assert kind == "own"
    r = _post(agent, "/inference", _body(PROMPTS[1], request_tag=tag,
                                         timeout=0.3))
    assert r.status_code == 408 and r.json()["in_flight"] is True
    joins = _counter(agent, "idempotent_joins")
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("r", _post(
        agent, "/inference", _body(PROMPTS[1], request_tag=tag))))
    t.start()
    _wait(lambda: _counter(agent, "idempotent_joins") > joins, "the join")
    result = {"status": "success", "tokens": [4, 5], "result": "x"}
    agent._idem_release(tag, ev, result)      # the owner finishes
    t.join(60)
    r = out["r"]
    assert r.status_code == 200
    assert r.json() == dict(result, idempotent=True)


def test_concurrent_duplicates_generate_once(workers):
    got = {}
    for side in SIDES:
        agent = workers(side, "batched")
        body = _body(PROMPTS[2], new=64, request_tag="dup-1")
        n0 = _counter(agent, "requests_completed")
        joins = _counter(agent, "idempotent_joins")
        held = _Held(agent.models[MODEL].batcher)
        with_results = []
        ts = [threading.Thread(target=lambda: with_results.append(
            _post(agent, "/inference", body))) for _ in range(2)]
        try:
            ts[0].start()
            _wait(lambda: _in_flight(agent, "dup-1"), "the first request")
            ts[1].start()
            _wait(lambda: _counter(agent, "idempotent_joins") > joins,
                  "the duplicate joining")
        finally:
            held.release()
        for t in ts:
            t.join(120)
        assert [r.status_code for r in with_results] == [200, 200]
        toks = [r.json()["tokens"] for r in with_results]
        assert toks[0] == toks[1]
        assert sum(bool(r.json().get("idempotent"))
                   for r in with_results) == 1
        assert _counter(agent, "requests_completed") - n0 == 1
        got[side] = toks[0]
    assert got["port"] == got["jax"]


# ---- /cancel --------------------------------------------------------------

@pytest.mark.parametrize("side", SIDES)
def test_cancel_codes_and_the_slot_is_freed(workers, side):
    agent = workers(side, "batched")
    assert _post(agent, "/cancel", {}).status_code == 400
    assert _post(agent, "/cancel", {"request_tag": "nope"}).status_code == 404
    free0 = _scheduler(agent)["blocks_free"]
    tag = f"cancel-{side}"
    out = {}
    held = _Held(agent.models[MODEL].batcher)
    t = threading.Thread(target=lambda: out.setdefault("r", _post(
        agent, "/inference", _body(PROMPTS[2], new=LONG, request_tag=tag))))
    try:
        t.start()
        req = _running(agent, tag, held)
        assert _scheduler(agent)["active"] == 1
        assert _scheduler(agent)["blocks_free"] < free0
        c = _post(agent, "/cancel", {"request_tag": tag})
        assert c.status_code == 200, c.text
        held.allow()              # the next step drops the slot
        assert req.done.is_set() and len(req.tokens) < LONG
        assert _scheduler(agent)["blocks_free"] == free0
    finally:
        held.release()
    t.join(60)
    r = out["r"]
    assert r.status_code == 400 and "cancel" in r.json()["message"]
    _wait(lambda: _scheduler(agent)["active"] == 0, "the slot freed")
    assert _scheduler(agent)["blocks_free"] == free0
    assert _counter(agent, "requests_cancelled") >= 1
    assert _post(agent, "/cancel", {"request_tag": tag}).status_code == 404


# ---- /drain, /undrain ----------------------------------------------------

@pytest.mark.parametrize("side", SIDES)
def test_drain_waits_for_the_request_in_flight(workers, side):
    agent = workers(side, "batched")
    tag = f"drain-{side}"
    out = {}
    held = _Held(agent.models[MODEL].batcher)
    t = threading.Thread(target=lambda: out.setdefault("r", _post(
        agent, "/inference", _body(PROMPTS[0], new=LONG, request_tag=tag))))
    d = threading.Thread(target=lambda: out.setdefault("d", _post(
        agent, "/drain", {"timeout": 60})))
    try:
        t.start()
        _running(agent, tag, held)
        d.start()
        _wait(lambda: agent._draining, "the drain")
        _check_draining(agent)
        assert "d" not in out     # /drain waits for the request
    finally:
        held.release()
    t.join(120)
    d.join(120)
    assert out["r"].status_code == 200, out["r"].text
    assert len(out["r"].json()["tokens"]) == LONG
    assert out["d"].status_code == 200
    assert out["d"].json()["drained"] is True
    assert out["d"].json()["in_flight"] == 0
    assert _post(agent, "/undrain", {}).status_code == 200
    assert requests.get(_url(agent, "/health"),
                        timeout=30).json()["status"] == "online"
    assert _post(agent, "/inference", _body(PROMPTS[1])).status_code == 200


def _check_draining(agent):
    health = requests.get(_url(agent, "/health"), timeout=30).json()
    assert health["status"] == "draining" and health["role"] == "mixed"
    assert "arena_occupancy" in health
    for path, body in (("/inference", _body(PROMPTS[1])),
                       ("/inference_stream", _body(PROMPTS[1])),
                       ("/inference_batch",
                        {"model_name": MODEL, "requests": [_body([3])]})):
        r = _post(agent, path, body)
        assert r.status_code == 503, (path, r.text)
        assert r.json()["draining"] is True
        assert r.headers["Retry-After"] == "5"


# ---- /inference_batch -------------------------------------------------------

def _jsonl(r):
    return [json.loads(line) for line in r.iter_lines() if line]


@pytest.mark.parametrize("mode", ["engine", "batched"])
def test_inference_batch_lines_and_per_sub_failure(workers, mode):
    got = {}
    for side in SIDES:
        agent = workers(side, mode)
        subs = [_body(p, request_tag=f"b-{mode}-{i}")
                for i, p in enumerate(PROMPTS)]
        subs.insert(1, _body([], request_tag=f"b-{mode}-bad"))
        subs.append(_body(PROMPTS[0]))            # untagged
        n0 = _counter(agent, "batch_rpcs")
        r = _post(agent, "/inference_batch",
                  {"model_name": MODEL, "requests": subs}, stream=True)
        assert r.status_code == 200
        assert r.headers["Content-Type"] == "application/jsonlines"
        lines = _jsonl(r)
        assert len(lines) == len(subs)
        by_tag = {ln["request_tag"]: ln for ln in lines}
        assert by_tag[f"b-{mode}-bad"]["status"] == 400
        ok = [ln for ln in lines if ln["status"] == 200]
        assert len(ok) == len(subs) - 1
        assert _counter(agent, "batch_rpcs") - n0 == 1
        got[side] = {ln["request_tag"]: ln["body"]["tokens"] for ln in ok}
    assert got["port"] == got["jax"]


WRONG_TYPE = {"sampling-not-a-dict": {"sampling": "x"},
              "temperature-null": {"sampling": {"temperature": None}},
              "token-null": {"prompt_tokens": [None]}}


@pytest.mark.parametrize("bad", list(WRONG_TYPE))
def test_inference_batch_sub_of_the_wrong_type_resolves_alone(workers, bad):
    # a prep error other than KeyError/ValueError answers that sub alone,
    # and leaks neither its siblings' inference counts nor its tag claim
    got = {}
    for side in SIDES:
        agent = workers(side, "batched")
        tag = f"wt-{bad}"
        subs = [_body(PROMPTS[0], request_tag=f"{tag}-a"),
                dict(_body(PROMPTS[1], request_tag=tag), **WRONG_TYPE[bad]),
                _body(PROMPTS[2], request_tag=f"{tag}-c")]
        r = _post(agent, "/inference_batch",
                  {"model_name": MODEL, "requests": subs}, stream=True)
        assert r.status_code == 200
        by_tag = {ln["request_tag"]: ln for ln in _jsonl(r)}
        assert len(by_tag) == len(subs)
        assert by_tag[f"{tag}-a"]["status"] == 200
        assert by_tag[f"{tag}-c"]["status"] == 200
        status = by_tag[tag]["status"]
        assert status in (400, 500), by_tag[tag]
        d = _post(agent, "/drain", {"timeout": 30})
        assert d.status_code == 200 and d.json()["drained"] is True, d.text
        assert _post(agent, "/undrain", {}).status_code == 200
        retry = _post(agent, "/inference", _body(PROMPTS[1], request_tag=tag))
        assert retry.status_code == 200, retry.text
        assert "idempotent" not in retry.json()
        got[side] = (status, by_tag[f"{tag}-a"]["body"]["tokens"],
                     by_tag[f"{tag}-c"]["body"]["tokens"],
                     retry.json()["tokens"])
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("side", SIDES)
def test_inference_batch_refuses_past_the_cap(workers, side, monkeypatch):
    agent = workers(side, "batched")
    monkeypatch.setattr(port_worker if side == "port" else jax_worker,
                        "BATCH_RPC_MAX", 2)
    subs = [_body([3 + i]) for i in range(3)]
    r = _post(agent, "/inference_batch",
              {"model_name": MODEL, "requests": subs})
    assert r.status_code == 400 and "at most 2" in r.json()["message"]
    r = _post(agent, "/inference_batch", {"model_name": MODEL,
                                          "requests": []})
    assert r.status_code == 400


def test_submit_many_keeps_order_and_is_all_or_nothing(weights):
    _, _, tcfg, tparams = weights
    b = ContinuousBatcher(tcfg, tparams, num_blocks=32, block_size=8,
                          slots=2, max_seq=64, device="cpu")
    specs = [{"prompt": [1 + i, 2, 3], "max_new_tokens": 4,
              "sampling": SamplingParams.greedy()} for i in range(5)]
    reqs = b.submit_many(specs)
    assert [r.prompt[0] for r in reqs] == [1, 2, 3, 4, 5]
    assert [q.prompt[0] for q in b.queue] == [1, 2, 3, 4, 5]
    assert b.inflight() == 5
    bad = specs[:2] + [{"prompt": [1], "max_new_tokens": 999,
                        "sampling": SamplingParams.greedy()}]
    with pytest.raises(ValueError):
        b.submit_many(bad)
    assert len(b.queue) == 5
    for _ in range(200):
        if not b.step() and not b.queue:
            break
    assert b.inflight() == 0 and all(r.done.is_set() for r in reqs)


# ---- /inference_stream -------------------------------------------------------

def _sse(r):
    return [json.loads(line[len(b"data: "):]) for line in r.iter_lines()
            if line.startswith(b"data: ")]


@pytest.mark.parametrize("mode", ["engine", "batched"])
def test_inference_stream_events_equal_jax(workers, mode):
    got = {}
    for side in SIDES:
        agent = workers(side, mode)
        body = dict(_body(None, new=12), prompt="hi there")
        del body["prompt_tokens"]
        r = _post(agent, "/inference_stream", body, stream=True)
        assert r.status_code == 200
        assert r.headers["Content-Type"] == "text/event-stream"
        events = _sse(r)
        assert [e["event"] for e in events[:-1]] == ["token"] * (
            len(events) - 1)
        done = events[-1]
        assert done["event"] == "done", done
        toks = [e["token"] for e in events[:-1]]
        assert [e["step"] for e in events[:-1]] == list(range(len(toks)))
        ref = _post(agent, "/inference", body).json()
        assert toks == ref["tokens"] and done["result"] == ref["result"]
        assert ("tokens_per_s" if mode == "engine" else "ttft_ms") in done
        got[side] = events[:-1]
        bad = _post(agent, "/inference_stream",
                    _body([], new=4))
        assert bad.status_code == 400 and bad.json()["status"] == "error"
    assert got["port"] == got["jax"]


# ---- auth and lease fencing --------------------------------------------------

@pytest.mark.parametrize("side", SIDES)
def test_auth_refuses_a_call_without_the_bearer_token(side):
    agent = _agent(side, auth_key="sekret")
    try:
        for path in ("/health", "/metrics"):
            r = requests.get(_url(agent, path), timeout=30)
            assert r.status_code == 401 and r.json()["status"] == "error"
        r = _post(agent, "/inference", _body([3]))
        assert r.status_code == 401
        r = requests.get(_url(agent, "/health"), timeout=30,
                         headers={"Authorization": "Bearer wrong"})
        assert r.status_code == 401
        ok = {"Authorization": "Bearer sekret"}
        r = requests.get(_url(agent, "/health"), timeout=30, headers=ok)
        assert r.status_code == 200 and r.json()["status"] == "online"
        r = requests.get(_url(agent, "/metrics"), timeout=30, headers=ok)
        assert r.status_code == 200
        assert r.headers["Content-Type"] == "text/plain; version=0.0.4"
    finally:
        _stop(agent)


def _fenced(term, nonce="leader-a"):
    return {"X-DLI-Master-Term": str(term), "X-DLI-Master-Nonce": nonce}


FENCED_ROUTES = [("/inference", lambda: _body([3], new=2)),
                 ("/inference_batch",
                  lambda: {"model_name": MODEL, "requests": [_body([3])]}),
                 ("/inference_stream", lambda: _body([3], new=2)),
                 ("/cancel", lambda: {"request_tag": "none"}),
                 ("/drain", lambda: {"timeout": 1}),
                 ("/undrain", lambda: {}),
                 ("/unload_model", lambda: {"model_name": "not-loaded"})]


@pytest.mark.parametrize("route,body", FENCED_ROUTES,
                         ids=[r for r, _ in FENCED_ROUTES])
def test_a_stale_master_term_gets_409(route, body):
    answers = {}
    for side in SIDES:
        agent = _agent(side)
        try:
            seen = []
            # term 5 holds the lease; an unfenced call passes too
            r = _post(agent, "/cancel", {"request_tag": "x"},
                      headers=_fenced(5))
            assert r.status_code == 404
            for headers in (_fenced(3), _fenced(5, nonce="leader-b")):
                r = _post(agent, route, body(), headers=headers)
                assert r.status_code == 409, r.text
                assert r.json()["stale_term"] is True
                assert r.headers["X-DLI-Stale-Term"] == "5"
                seen.append(r.status_code)
            assert not agent._draining          # a fenced drain did nothing
            r = _post(agent, route, body(), headers=_fenced(6))
            seen.append(r.status_code)
            r = _post(agent, route, body())
            seen.append(r.status_code)
            assert _counter(agent, "stale_term_rejections") == 2
            answers[side] = seen
        finally:
            _stop(agent)
    assert answers["port"] == answers["jax"]


# ---- the engine's stream_cb -----------------------------------------------

@pytest.mark.parametrize("eos", [False, True], ids=["no-eos", "eos"])
def test_engine_stream_cb_equals_generate_and_jax(workers, weights, eos):
    jeng = workers("jax", "engine").models[MODEL].engine
    teng = workers("port", "engine").models[MODEL].engine
    prompts = [PROMPTS[0], PROMPTS[1]]
    plain = teng.generate(prompts, max_new_tokens=10,
                          sampling=SamplingParams.greedy()).tokens
    stop = plain[0][4] if eos else None
    mine, ref = [], []
    res = teng.generate(prompts, max_new_tokens=10,
                        sampling=SamplingParams.greedy(), eos_token_id=stop,
                        stream_cb=lambda s, t: mine.append((s, list(t))))
    jres = jeng.generate(prompts, max_new_tokens=10,
                         sampling=JaxSamplingParams.greedy(),
                         eos_token_id=stop,
                         stream_cb=lambda s, t: ref.append((s, list(t))))
    assert res.tokens == jres.tokens
    if not eos:
        assert res.tokens == plain
    assert mine == ref
    assert mine[0] == (0, [plain[0][0], plain[1][0]])
    streamed = [[t[i] for _, t in mine if t[i] is not None]
                for i in range(2)]
    for i in range(2):   # an eos is streamed, then trimmed from tokens
        assert streamed[i][:len(res.tokens[i])] == res.tokens[i]


def test_stream_cb_stays_on_the_leader_under_tp2(weights):
    _, _, tcfg, tparams = weights
    tp2 = InferenceEngine(tcfg, tparams, mesh_spec=MeshSpec(tp=2),
                          max_seq=96, device="cpu")
    agent = WorkerAgent(device="cpu")
    try:
        g = SamplingParams.greedy()
        tp2.reset_counts()
        plain = tp2.generate([PROMPTS[0]], max_new_tokens=6, sampling=g)
        counts = [s["collectives"] for s in tp2.rank_stats()]
        tp2.reset_counts()
        seen = []
        res = tp2.generate([PROMPTS[0]], max_new_tokens=6, sampling=g,
                           stream_cb=lambda s, t: seen.append(t[0]))
        assert res.tokens == plain.tokens and seen == plain.tokens[0]
        assert [s["collectives"] for s in tp2.rank_stats()] == counts
        agent.models[MODEL] = LoadedModel(tp2, load_tokenizer(None, 256),
                                          "test")
        agent.serve("127.0.0.1", 0, background=True)
        r = _post(agent, "/inference_stream", _body(PROMPTS[0], new=6),
                  stream=True)
        events = _sse(r)
        assert [e["token"] for e in events[:-1]] == plain.tokens[0]
        assert events[-1]["event"] == "done"
    finally:
        agent.service.shutdown()
        tp2.close()
    assert not tp2._leader.alive()
