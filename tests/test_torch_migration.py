"""Live migration with port workers, and across the two packages (CPU,
tiny-llama f32, the JAX init bridged to the port bit for bit).

- The batcher: a request migrated mid-stream (``migrate_out`` serviced at
  the next step) and resumed on a second batcher from its record, the
  source's exported KV handed over in the arena, streams tokens that
  partition the undisturbed run's exactly, greedy and sampled (zero
  duplicated, zero lost; the destination restores blocks); a migrate
  that races completion returns None and leaves the result; a queued
  request hands off its record alone; a handoff counts as migrated, not
  failed.
- The workers, as the master drives them: ``/migrate_out`` on the source
  mid-stream (its scheduler held step by step, so nothing races), the
  source's dispatch answering 303 with the resume record, then the
  request re-dispatched to the destination with the record and the
  source as its ``kv_source``: port to port (greedy and sampled), port to
  JAX and JAX to port (greedy); the destination's tokens equal the
  undisturbed run's and its fetch moved blocks. The resume record's keys
  equal the JAX worker's, and ``/migrate_out`` answers the JAX worker's
  codes: 400 without a tag, 404 for a tag not in flight, 409 for a
  request that completed first.
"""

import concurrent.futures
import threading
import time

import pytest
import requests

from distributed_llm_inferencing_tpu.ops.sampling import (
    SamplingParams as JaxSamplingParams)
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.utils.tokenizer import (
    load_tokenizer)
from test_torch_disagg import LONG, MODEL, POOL, _Fleet
from test_torch_e2e_master import _Held
from test_torch_families import one_torch_thread  # noqa: F401

PROMPT = list(range(7, 28))     # 21 tokens: two full 8-token blocks
SAMPLED = SamplingParams(temperature=0.8, top_k=20)


@pytest.fixture(scope="module")
def fleet():
    f = _Fleet()
    f.p_src, f.p_dst = f.port("mixed"), f.port("mixed")
    f.j_src, f.j_dst = f.jax("mixed"), f.jax("mixed")
    for agent, _ in (f.p_src, f.p_dst, f.j_src, f.j_dst):
        # 4-token chunks: a 24-token stream spans several steps
        agent.models[MODEL].batcher.DECODE_CHUNKS = (4,)
    yield f
    f.close()


def _batcher(fleet, **kw):
    b = ContinuousBatcher(fleet.tcfg, fleet.tparams, device="cpu",
                          kv_host_mb=8, **dict(POOL, **kw))
    b.DECODE_CHUNKS = (4,)
    return b


def _steps_until(b, pred, limit=200):
    for _ in range(limit):
        if pred():
            return
        b.step()
    raise AssertionError("never got there")


def _until(pred, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.001)


def _migrate(b, req):
    """``migrate_out`` on another thread, serviced by one step here."""
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(b.migrate_out, req, 30.0)
        _until(lambda: req._migrate_requested, "the migration flag")
        b.step()
        return fut.result()


# ---- the batcher ----------------------------------------------------------

@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_batcher_migrate_stream_zero_dup_zero_loss(fleet, sampled):
    sp = SAMPLED if sampled else SamplingParams.greedy()
    ref_b = _batcher(fleet)
    ref = ref_b.submit(PROMPT, 40, sp, seed=5)
    _steps_until(ref_b, ref.done.is_set)
    src, s1 = _batcher(fleet), []
    req = src.submit(PROMPT, 40, sp, stream_cb=s1.append, seed=5)
    _steps_until(src, lambda: len(req.tokens) >= 6)
    rec = _migrate(src, req)
    assert rec is not None and req._migrated and req.error == "migrated"
    assert rec["tokens"] == s1 and 0 < len(s1) < 40
    assert rec["seed"] == 5 and rec["steps"] == len(s1)
    dst, s2 = _batcher(fleet), []
    for d in list(src.kvtier.arena._entries):
        dst.kvtier.arena.put(d, src.kvtier.arena.peek_pages(d),
                             count_offload=False)
    req2 = dst.submit(rec["prompt_tokens"], rec["max_new_tokens"], sp,
                      stream_cb=s2.append, eos_token_id=rec["eos_token_id"],
                      resume=rec)
    _steps_until(dst, req2.done.is_set)
    assert s1 + s2 == req2.wait() == ref.wait()
    assert dst.metrics.snapshot()["counters"]["kvtier_restored_blocks"] > 0


def test_batcher_migrate_races_completion_returns_none(fleet):
    b = _batcher(fleet)
    req = b.submit(PROMPT, 2, SamplingParams.greedy())
    _steps_until(b, req.done.is_set)
    assert b.migrate_out(req, timeout=2.0) is None
    assert not req._migrated and not req.error and len(req.tokens) == 2


def test_batcher_migrate_queued_request_and_accounting(fleet):
    b = _batcher(fleet, slots=1)
    hog = b.submit(PROMPT, 60, SamplingParams.greedy())
    _steps_until(b, lambda: len(hog.tokens) >= 2)
    queued = b.submit(list(range(40, 55)), 20, SamplingParams.greedy(),
                      seed=3)
    rec = _migrate(b, queued)
    assert rec["tokens"] == [] and rec["prompt_tokens"] == \
        list(range(40, 55)) and rec["seed"] == 3
    assert _migrate(b, hog)["tokens"] == hog.tokens
    c = b.metrics.snapshot()["counters"]
    assert c["batcher_requests_migrated"] == 2
    assert c["batcher_requests_submitted"] == (
        c.get("batcher_requests_completed", 0)
        + c.get("batcher_requests_failed", 0) + 2)
    assert not any(b.active) and not b.queue


# ---- the workers ------------------------------------------------------------

def _body(prompt, seed, sampled, **extra):
    return dict({"model_name": MODEL, "prompt": prompt,
                 "max_new_tokens": 24, "seed": seed,
                 "sampling": {"do_sample": sampled, "temperature": 0.8,
                              "top_k": 20}}, **extra)


def _migrate_worker(src, prompt, seed, sampled, tag):
    """The request on worker ``src`` (agent, url) with its scheduler held:
    a few steps, then ``/migrate_out``, serviced by one more step. The
    dispatch's answer (a 303 with the resume record) and /migrate_out's
    are returned."""
    agent, url = src
    b = agent.models[MODEL].batcher
    held = _Held(b)
    out = {}
    try:
        t = threading.Thread(target=lambda: out.setdefault(
            "r", requests.post(url + "/inference", json=_body(
                prompt, seed, sampled, request_tag=tag), timeout=120)))
        t.start()
        _until(lambda: tag in agent._tagged or "r" in out, "the dispatch")
        assert "r" not in out, out["r"].text
        req = agent._tagged[tag]
        while len(req.tokens) < 5:
            held.allow()
        m = threading.Thread(target=lambda: out.setdefault(
            "m", requests.post(url + "/migrate_out", json={
                "request_tag": tag, "model_name": MODEL}, timeout=60)))
        m.start()
        _until(lambda: req._migrate_requested, "the migration flag")
        held.allow()
        m.join(60)
        t.join(60)
    finally:
        held.release()
    return out["r"], out["m"]


@pytest.mark.parametrize("route,sampled", [
    ("port>port", False), ("port>port", True), ("port>jax", False),
    ("jax>port", False)])
def test_worker_migrate_resume_across_workers(fleet, route, sampled):
    src = {"port": fleet.p_src, "jax": fleet.j_src}[route.split(">")[0]]
    dst = {"port": fleet.p_dst, "jax": fleet.j_dst}[route.split(">")[1]]
    # a first block of its own: nothing of it cached on the destination
    prompt = f"{route[0]}{route[-1]}{int(sampled)} " + LONG[:60]
    seed = 21 if sampled else 22
    resp, mig = _migrate_worker(src, prompt, seed, sampled,
                                f"mig-{route}-{sampled}")
    assert mig.status_code == 200 and mig.json()["status"] == "success"
    assert resp.status_code == 303, resp.text
    rec = resp.json()["resume"]
    assert resp.json()["status"] == "migrated" and 5 <= len(rec["tokens"])
    # undisturbed: the source again (its prompt blocks cached)
    ref = requests.post(src[1] + "/inference", json=_body(prompt, seed,
                                                          sampled),
                        timeout=120).json()["tokens"]
    before = dst[0].metrics.snapshot()["counters"].get(
        "kv_transfer_blocks", 0)
    got = requests.post(dst[1] + "/inference", json=_body(
        prompt, seed, sampled, resume=rec,
        kv_source={"url": src[1], "model": MODEL}), timeout=120)
    assert got.status_code == 200, got.text
    toks = got.json()["tokens"]
    assert toks[:len(rec["tokens"])] == rec["tokens"] and toks == ref
    n = len(load_tokenizer(None, 256).encode(prompt)) + len(rec["tokens"])
    assert dst[0].metrics.snapshot()["counters"]["kv_transfer_blocks"] \
        - before == (n - 2) // 8    # the KV on the source's device
    assert src[0].metrics.snapshot()["counters"]["requests_migrated_out"] \
        >= 1


def test_resume_record_keys_equal_the_jax_workers(fleet):
    recs = {}
    for name, src in (("port", fleet.p_src), ("jax", fleet.j_src)):
        resp, _ = _migrate_worker(src, f"k{name[0]} " + LONG[:60], 3, False,
                                  f"keys-{name}")
        recs[name] = resp.json()["resume"]
    assert sorted(recs["port"]) == sorted(recs["jax"])
    assert {k: type(v) for k, v in recs["port"].items()} == \
        {k: type(v) for k, v in recs["jax"].items()}


def test_migrate_out_codes_match_the_jax_worker(fleet):
    codes = {}
    for name, (agent, url) in (("port", fleet.p_src), ("jax", fleet.j_src)):
        b = agent.models[MODEL].batcher
        sp = (SamplingParams if name == "port" else JaxSamplingParams)
        done = b.submit(PROMPT, 2, sp.greedy())
        done.wait(60)
        agent._tagged["completed-first"] = done
        try:
            codes[name] = [requests.post(url + "/migrate_out", json=body,
                                         timeout=30).status_code
                           for body in ({}, {"request_tag": "ghost"},
                                        {"request_tag": "completed-first",
                                         "model_name": MODEL})]
        finally:
            agent._tagged.pop("completed-first")
    assert codes["port"] == codes["jax"] == [400, 404, 409]
