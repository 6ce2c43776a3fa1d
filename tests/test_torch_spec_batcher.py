"""The batcher's speculative chunk, wave mode and overlapped dispatch, held
against the JAX package's batcher (CPU, f32).

- Greedy tokens of the port's speculative batcher (adaptive off; wave on
  and off on the float weights, wave on elsewhere) equal the JAX
  batcher's, on the tiny qwen2 variant's
  float weights (the llama arm with GQA and q/k/v biases), its int8
  weights, an ALiBi family (bloom) and a windowed switch case (qwen2
  with a window of 5 on its second layer), four prompts each (two
  repetitive, so drafts accept); the JAX reference is its plain batcher
  (its greedy speculative tokens equal its plain ones). On an int8 KV
  pool, whose chunk semantics make tokens depend on where chunks end,
  the reference is the JAX speculative batcher itself (wave on, adaptive
  off), with the port's wave on and off.
- The chunk itself (the batcher's ``_run_spec_decode`` against its
  ``_run_decode`` over the same pool): greedy rows emit the plain chunk's
  tokens, a width-0 sampled row the plain chunk's sampled tokens, budgets
  are exact, and an eos inside an accepted run stops the row there and
  sets its flag.
- Wave mode: a sampled request whose controller keeps it at width 0
  rides the verify passes of a drafting chunk-mate and emits the plain
  batcher's tokens.
- Overlapped dispatch: tokens with the overlap on equal it off and the
  JAX batcher's; the overlap counter is above 0 on eligible traffic and
  stays 0 with eos, with a stream callback, and while requests queue.
"""

import numpy as np
import pytest

from distributed_llm_inferencing_tpu.ops.sampling import (
    SamplingParams as JaxSamplingParams)
from distributed_llm_inferencing_tpu.runtime.batcher import (
    ContinuousBatcher as JaxBatcher)
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.ops.speculative import (
    AdaptiveSpecController)
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from test_torch_families import family_pair, one_torch_thread  # noqa: F401

POOL = dict(num_blocks=128, block_size=8, slots=4, max_seq=96, seed=0)
NEW = 16
GREEDY = SamplingParams.greedy()
SAMPLED = SamplingParams(temperature=0.9, top_k=20, top_p=0.9)


def prompts():
    rng = np.random.default_rng(7)
    a, b = rng.integers(1, 256, 5).tolist(), rng.integers(1, 256, 3).tolist()
    return [(a * 5)[:21], rng.integers(1, 256, 9).tolist(), (b * 6)[:14],
            rng.integers(1, 256, 17).tolist()]


def drive(b, sampling=None, chunks=(4,), max_new=NEW, **submit):
    """Every prompt through batcher ``b`` (greedy unless ``sampling``), one
    step at a time: the tokens per request."""
    b.DECODE_CHUNKS = chunks
    sp = sampling or (JaxSamplingParams.greedy() if isinstance(b, JaxBatcher)
                      else GREEDY)
    reqs = [b.submit(p, max_new_tokens=max_new, sampling=sp, seed=50 + i,
                     **submit) for i, p in enumerate(prompts())]
    for _ in range(400):
        b.step()
        if all(r.done.is_set() for r in reqs):
            break
    return [r.wait() for r in reqs]


_CASES = {
    "float": ("qwen2-7b", {}),
    "int8_weights": ("qwen2-7b", {"quant": "int8"}),
    "alibi": ("bloom-7b1", {}),
    "window": ("qwen2-7b", {"attn_windows": (None, 5)}),
}
_JAX_REF = {}


def _pair(case):
    """(JAX params, numpy tree, port config, JAX config) of a case, and
    its JAX batcher's greedy tokens, once per module."""
    name, over = _CASES[case]
    jcfg, jparams, tree, model = family_pair(name, **over)
    if case not in _JAX_REF:
        _JAX_REF[case] = drive(JaxBatcher(jcfg, jparams, **POOL))
    return tree, model.cfg, _JAX_REF[case]


def _port(tree, cfg, **kw):
    return ContinuousBatcher(cfg, params_from_jax(tree, cfg, "cpu"),
                             device="cpu", **dict(POOL, **kw))


@pytest.mark.parametrize("case", list(_CASES))
def test_spec_greedy_tokens_match_the_jax_batcher(monkeypatch, case):
    """Wave on and off on the float weights; wave on (the default) for
    the other cases (the two modes share the chunk and differ in how the
    widths are chosen)."""
    monkeypatch.setenv("DLI_FUSED_DECODE", "0")
    tree, cfg, ref = _pair(case)
    for wave in ((True, False) if case == "float" else (True,)):
        b = _port(tree, cfg, speculative="ngram", spec_gamma=3,
                  spec_adaptive=False, spec_wave=wave)
        assert drive(b, chunks=(8, 4)) == ref, (case, wave)
        if case == "float":
            c = b.metrics.snapshot()["counters"]
            # the repetitive prompts' drafts were accepted
            assert b.stats()["spec_accepted_tokens"] > 0
            assert c["batcher_weight_passes"] < c["batcher_tokens_emitted"]
            assert b.stats()["spec_wave"] is None or wave
        b.stop()


def test_spec_greedy_tokens_on_an_int8_kv_pool_match_the_jax_batcher():
    jcfg, jparams, tree, model = family_pair("qwen2-7b", kv_quant="int8")
    jb = JaxBatcher(jcfg, jparams, **POOL, speculative="ngram",
                    spec_gamma=2, spec_adaptive=False, spec_wave=True)
    ref = drive(jb)
    for wave in (True, False):
        b = _port(tree, model.cfg, speculative="ngram", spec_gamma=2,
                  spec_adaptive=False, spec_wave=wave)
        assert drive(b) == ref, wave
        b.stop()


# ---- the chunk ----------------------------------------------------------

def _admitted(cfg, tree, sps):
    """A speculative port batcher with the prompts admitted (their first
    tokens sampled) and growth for NEW tokens; the chunk inputs."""
    b = _port(tree, cfg, speculative="ngram", spec_gamma=3,
              spec_adaptive=False)
    reqs = [b.submit(p, max_new_tokens=NEW + 1, sampling=sp, seed=70 + i)
            for i, (p, sp) in enumerate(zip(prompts(), sps))]
    b._admit_wave()
    a = b._chunk_inputs(NEW)
    for i, req in enumerate(b.active):
        assert b._ensure_growth(i, NEW)
        sp = req.sampling
        a["tokens"][i], a["seeds"][i] = req.tokens[-1], req.seed
        a["steps"][i], a["budget"][i] = len(req.tokens), NEW
        a["temps"][i], a["tks"][i] = sp.temperature, sp.top_k
        a["tps"][i], a["ds"][i] = sp.top_p, sp.do_sample
    return b, reqs, a


def _spec_rows(b, a, gammas, k):
    toks, keeps, eos_seen = b._run_spec_decode(dict(
        a, k=k, gamma=3, gammas=np.asarray(gammas, np.int32)))
    rows = [[int(x) for t in range(k) for x in toks[t, r, :keeps[t, r]]]
            for r in range(toks.shape[1])]
    return rows, eos_seen


def test_spec_chunk_matches_the_plain_chunk():
    """Greedy rows at width 3 and sampled rows at width 0 emit the plain
    chunk's tokens over the same pool; the budget is exact; an eos met
    inside a run stops its row there, with the eos flag set."""
    _, _, tree, model = family_pair("qwen2-7b")
    sps = [GREEDY, SAMPLED, GREEDY, SAMPLED]
    b, _, a = _admitted(model.cfg, tree, sps)
    pool = [lf.clone() for lf in b.paged.leaves()]
    ptoks, pemits = b._run_decode(a)
    plain = [ptoks[:int(pemits[:, r].sum()), r].tolist() for r in range(4)]
    for lf, saved in zip(b.paged.leaves(), pool):
        lf.copy_(saved)
    spec, eos_seen = _spec_rows(b, a, [3, 0, 3, 0], NEW)
    assert spec == plain
    assert not eos_seen[-1].any()
    # eos: row 0 stops before its plain chunk's 6th token
    for lf, saved in zip(b.paged.leaves(), pool):
        lf.copy_(saved)
    eos = plain[0][5]
    a["eos"][0] = eos
    spec, eos_seen = _spec_rows(b, a, [3, 0, 3, 0], NEW)
    cut = plain[0].index(eos)
    assert spec[0] == plain[0][:cut] and bool(eos_seen[-1, 0])
    assert spec[1:] == plain[1:]


def test_width0_sampled_request_rides_the_wave_with_plain_tokens():
    """In wave mode, a sampled request whose controller stays plain rides
    the verify passes of its drafting chunk-mates at width 0 and emits
    exactly the plain batcher's tokens."""
    _, _, tree, model = family_pair("qwen2-7b")
    plain = drive(_port(tree, model.cfg), sampling=SAMPLED)
    b = _port(tree, model.cfg, speculative="ngram", spec_gamma=3,
              spec_adaptive=True, spec_wave=True)
    b.DECODE_CHUNKS = (4,)
    reqs = []
    for i, p in enumerate(prompts()):
        sp = GREEDY if i % 2 == 0 else SAMPLED
        req = b.make_request(p, NEW, sp, seed=50 + i)
        if sp is SAMPLED:
            ctl = AdaptiveSpecController(3, probe_every=10 ** 6)
            ctl.mode = "plain"
            req._spec_ctl = ctl
        reqs.append(req)
    b.enqueue(reqs)
    while not all(r.done.is_set() for r in reqs):
        b.step()
    assert [r.wait() for i, r in enumerate(reqs) if i % 2] == \
        [plain[i] for i in (1, 3)]
    c = b.metrics.snapshot()["counters"]
    assert c["spec_wave_plain_rides"] > 0 and c["spec_wave_dispatches"] > 0


# ---- overlapped dispatch ------------------------------------------------

def test_overlap_tokens_and_counter():
    tree, cfg, ref = _pair("float")
    out = {}
    for on in (False, True):
        b = _port(tree, cfg, decode_overlap=on)
        out[on] = drive(b)
        assert (b.stats()["overlapped_dispatches"] > 0) == on
        b.stop()
    assert out[True] == out[False] == ref
    # sampled rows draw per (seed, step): the same with the pair
    b0 = _port(tree, cfg, decode_overlap=False)
    b1 = _port(tree, cfg, decode_overlap=True)
    assert drive(b0, sampling=SAMPLED) == drive(b1, sampling=SAMPLED)


@pytest.mark.parametrize("blocker", ["eos", "stream", "queue"])
def test_overlap_stays_off_when_a_host_decision_may_be_due(blocker):
    tree, cfg, _ = _pair("float")
    b = _port(tree, cfg, decode_overlap=True, **(
        {"slots": 2} if blocker == "queue" else {}))
    kw = {"eos": {"eos_token_id": 255}, "stream": {"stream_cb": id},
          "queue": {}}[blocker]
    b.DECODE_CHUNKS = (4,)
    reqs = [b.submit(p, max_new_tokens=NEW, sampling=GREEDY, seed=i, **kw)
            for i, p in enumerate(prompts())]
    while not all(r.done.is_set() for r in reqs):
        before = b.stats()["overlapped_dispatches"]
        b.step()
        # a request still queued after the step was queued at its decode
        if blocker != "queue" or len(b.queue) > 0:
            assert b.stats()["overlapped_dispatches"] == before
    if blocker == "queue":   # the last two, once nothing queues, may pair
        assert b.metrics.snapshot()["counters"][
            "batcher_requests_completed"] == 4
