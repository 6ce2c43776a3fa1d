"""The port's speculative decoding ops and the engine's speculative path,
held against the JAX package (CPU, f32).

- ``propose_ngram`` and ``propose_ngram_device`` equal the JAX ones,
  bitwise, on seeded histories over a small vocabulary (many repeated
  bigrams) and on histories too short to draft.
- ``AdaptiveSpecController``: one sequence of ``choose``/``record`` calls
  with fixed elapsed times (no clock) gives the JAX controller's mode,
  gamma, ``stats()`` and ``export_state()`` at every step; a state
  exported by either package loads in the other, and a malformed one is
  ignored field by field.
- ``warp_logits`` equals the JAX one's support and values.
- ``accept_rejection_batch``: greedy rows equal the JAX function's
  tokens and counts on the same logits and drafts, any widths; sampled
  rows accept at the analytic rate (the JAX test's closed form, within
  0.12 of the expected count over 400 seeds, as there), never re-emit a
  rejected draft, and a width-0 row emits ``sample_batch``'s token.
- The engine: speculative greedy tokens equal the JAX engine's plain and
  speculative tokens on repetitive and random prompts (eos and gamma
  variations), with fewer weight passes than tokens on the repetitive
  one; the verify step's first sampled token over 600 streams of one
  context matches the exact warped target distribution (total variation
  under 0.1), with a likely and an out-of-support draft, and sampled
  speculative tokens are seeded-deterministic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inferencing_tpu.models.params import (
    init_params as jax_init_params)
from distributed_llm_inferencing_tpu.models.registry import (
    get_config as jax_config)
from distributed_llm_inferencing_tpu.ops import sampling as jsmp
from distributed_llm_inferencing_tpu.ops import speculative as jspec
from distributed_llm_inferencing_tpu.runtime.engine import (
    InferenceEngine as JaxEngine)
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.models.registry import get_config
from distributed_llm_inferencing_tpu_torch.ops import sampling as tsmp
from distributed_llm_inferencing_tpu_torch.ops import speculative as tspec
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from test_torch_families import one_torch_thread  # noqa: F401

GREEDY = tsmp.SamplingParams.greedy()


# ---- drafting -----------------------------------------------------------

def _histories(seed, rows=24, width=48, vocab=5):
    rng = np.random.default_rng(seed)
    hist = np.zeros((rows, width), np.int32)
    lens = np.zeros((rows,), np.int32)
    for r in range(rows):
        n = int(rng.integers(1, width))
        hist[r, :n] = rng.integers(0, vocab, n)
        lens[r] = n
    return hist, lens


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("gamma", [1, 4])
def test_propose_ngram_matches_jax(seed, gamma):
    hist, lens = _histories(seed)
    for r in range(hist.shape[0]):
        row = hist[r, :lens[r]].tolist()
        assert tspec.propose_ngram(row, gamma) == \
            jspec.propose_ngram(row, gamma), row


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_propose_ngram_device_matches_jax(seed):
    hist, lens = _histories(seed)
    jd, jh = jspec.propose_ngram_device(jnp.asarray(hist),
                                        jnp.asarray(lens), 4)
    td, th = tspec.propose_ngram_device(torch.from_numpy(hist),
                                        torch.from_numpy(lens), 4)
    assert td.tolist() == np.asarray(jd).tolist()
    assert th.tolist() == np.asarray(jh).tolist()


def test_propose_ngram_device_short_histories():
    hist = np.asarray([[7, 0, 0, 0], [7, 7, 0, 0], [3, 4, 3, 4]], np.int32)
    lens = np.asarray([1, 2, 4], np.int32)
    jd, jh = jspec.propose_ngram_device(jnp.asarray(hist), jnp.asarray(lens),
                                        3)
    td, th = tspec.propose_ngram_device(torch.from_numpy(hist),
                                        torch.from_numpy(lens), 3)
    assert td.tolist() == np.asarray(jd).tolist() == [[7, 7, 7], [7, 7, 7],
                                                      [3, 4, 4]]
    assert th.tolist() == np.asarray(jh).tolist() == [False, False, True]


# ---- the adaptive controller --------------------------------------------

def _script(seed, n=160):
    """A seeded run of chunk outcomes: (drafted, accepted, emitted,
    elapsed_s) per chunk; acceptance swings between friendly and hostile
    phases, and the elapsed times are fixed numbers."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        friendly = (i // 40) % 2 == 0
        acc = rng.random() < (0.8 if friendly else 0.05)
        out.append((acc, float(rng.uniform(0.005, 0.02))))
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_controller_matches_jax_step_by_step(seed):
    jc, tc = jspec.AdaptiveSpecController(8), tspec.AdaptiveSpecController(8)
    for acc, dt in _script(seed):
        g = tc.choose()
        assert g == jc.choose()
        if g:
            a = g if acc else 0
            kw = dict(emitted=a + 1, elapsed_s=dt, drafted=g, accepted=a)
            jc.record("spec", **kw)
            tc.record("spec", **kw)
        else:
            jc.record("plain", emitted=1, elapsed_s=dt / 3)
            tc.record("plain", emitted=1, elapsed_s=dt / 3)
        assert (tc.mode, tc.gamma) == (jc.mode, jc.gamma)
        assert tc.stats() == jc.stats()
        assert tc.export_state() == jc.export_state()
    assert tc.fallbacks and tc.reactivations   # both transitions ran


def test_controller_state_crosses_packages():
    src = jspec.AdaptiveSpecController(8)
    src.gamma, src.mode = 2, "plain"
    src._accept.extend([(1, 4), (0, 4)])
    src._spec_chunks, src._plain_chunks = 9, 4
    port = tspec.AdaptiveSpecController(8)
    port.load_state(src.export_state())
    assert port.export_state() == src.export_state()
    back = jspec.AdaptiveSpecController(8)
    back.load_state(port.export_state())
    assert back.export_state() == src.export_state()
    bad = tspec.AdaptiveSpecController(8)
    bad.load_state({"gamma": "x", "mode": "bogus", "accept": [[1]],
                    "spec_chunks": None})
    assert (bad.gamma, bad.mode, list(bad._accept)) == (8, "spec", [])
    bad.load_state("not a dict")
    assert bad.export_state() == \
        jspec.AdaptiveSpecController(8).export_state()


# ---- warping and acceptance ---------------------------------------------

@pytest.mark.parametrize("sp", [
    tsmp.SamplingParams(), tsmp.SamplingParams(temperature=1.3, top_k=0,
                                               top_p=0.7),
    tsmp.SamplingParams(temperature=0.6, top_k=5, top_p=1.0),
    tsmp.SamplingParams.greedy()])
def test_warp_logits_matches_jax(sp):
    lg = np.random.default_rng(2).normal(0, 2, (3, 5, 97)).astype(np.float32)
    want = np.asarray(jsmp.warp_logits(jnp.asarray(lg), jsmp.SamplingParams(
        sp.temperature, sp.top_k, sp.top_p, sp.do_sample)))
    got = tsmp.warp_logits(torch.from_numpy(lg), sp).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)],
                               rtol=1e-6, atol=1e-6)


# the JAX function jitted once per shape (eagerly it retraces its vmaps)
_jax_accept = jax.jit(jspec.accept_rejection_batch)


def _acc_inputs(seed, r=6, g=3, v=64):
    rng = np.random.default_rng(seed)
    lg = rng.normal(0, 3, (r, g + 1, v)).astype(np.float32)
    targets = lg.argmax(-1)
    drafts = targets[:, :-1].copy()
    # row r's drafts agree with the argmax up to position r % (g + 1)
    for i in range(r):
        cut = i % (g + 1)
        drafts[i, cut:] = (drafts[i, cut:] + 1) % v
    widths = np.asarray([g, g, 1, 0, 2, g][:r], np.int32)
    return lg, drafts.astype(np.int32), widths


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_widths", [False, True])
def test_accept_rejection_greedy_matches_jax(seed, with_widths):
    lg, drafts, widths = _acc_inputs(seed)
    r = lg.shape[0]
    common = dict(temps=np.ones(r, np.float32), top_ks=np.zeros(r, np.int32),
                  top_ps=np.ones(r, np.float32), ds=np.zeros(r, bool))
    jt, jn = _jax_accept(
        jnp.asarray(lg), jnp.asarray(drafts), jnp.arange(r, dtype=jnp.int32),
        jnp.zeros(r, jnp.int32), *(jnp.asarray(common[k]) for k in (
            "temps", "top_ks", "top_ps", "ds")),
        jnp.asarray(widths if with_widths else np.full(r, 3, np.int32)))
    tt, tn = tspec.accept_rejection_batch(
        torch.from_numpy(lg), torch.from_numpy(drafts), torch.arange(r),
        torch.zeros(r, dtype=torch.int64),
        **{k: torch.from_numpy(v) for k, v in common.items()},
        widths=torch.from_numpy(widths) if with_widths else None)
    n = np.asarray(jn)
    assert tn.tolist() == n.tolist()
    jt = np.asarray(jt)
    for i in range(r):
        assert tt[i, :n[i]].tolist() == jt[i, :n[i]].tolist()


def test_accept_rejection_sampled_analytic_probability():
    """The JAX test's closed form: temp-1 top-20 logits with token 7
    favoured by L, every draft 7, so each position accepts with p = e^L /
    (e^L + sum of the 19 kept competitors' e^c) and the expected accepted
    count over G = 3 drafts is p + p^2 + p^3. The competitors' logits are
    distinct (the port's top-k keeps ties at the k-th value, where the
    JAX prefix tier breaks them by index), top_p 1. Over 400 seeds the
    mean lies within 0.12 of the closed form (the JAX test's tolerance),
    as does the JAX function's on the same inputs; a rejected position's
    residual draw never re-emits 7."""
    G, V, L, n = 3, 64, 5.0, 400
    comp = -0.05 * np.arange(V, dtype=np.float32)
    lg = np.broadcast_to(comp, (n, G + 1, V)).copy()
    lg[..., 7] = L
    kept = np.sort(np.delete(comp, 7))[::-1][:19]
    p = np.exp(L) / (np.exp(L) + np.exp(kept).sum())
    want = sum(p ** i for i in range(1, G + 1))
    toks, n_emit = tspec.accept_rejection_batch(
        torch.from_numpy(lg), torch.full((n, G), 7), torch.arange(n),
        torch.zeros(n, dtype=torch.int64), torch.ones(n),
        torch.full((n,), 20), torch.ones(n), torch.ones(n, dtype=torch.bool))
    n_acc = (n_emit - 1).float()
    assert abs(float(n_acc.mean()) - want) < 0.12, (float(n_acc.mean()), want)
    for i in range(n):
        a = int(n_acc[i])
        if a < G:
            assert int(toks[i, a]) != 7
    _, jn = _jax_accept(
        jnp.asarray(lg), jnp.full((n, G), 7, jnp.int32),
        jnp.arange(n, dtype=jnp.int32), jnp.zeros(n, jnp.int32),
        jnp.ones(n, jnp.float32), jnp.full((n,), 20, jnp.int32),
        jnp.ones(n, jnp.float32), jnp.ones(n, bool))
    assert abs(float(np.mean(np.asarray(jn) - 1)) - want) < 0.12


def test_width0_rows_draw_sample_batch_tokens():
    """A width-0 row judges no draft, and its stop token is
    ``sample_batch``'s draw at (seed, step) from position 0's logits,
    greedy or sampled, whatever its drafts."""
    lg, drafts, _ = _acc_inputs(5, r=8, g=2, v=80)
    r = lg.shape[0]
    seeds = torch.arange(100, 100 + r)
    steps = torch.arange(r) * 3
    temps = torch.full((r,), 0.9)
    tks = torch.tensor([0, 5, 40, 0, 5, 40, 0, 5])
    tps = torch.tensor([1.0, 0.9, 0.8, 0.7, 1.0, 0.9, 0.8, 0.95])
    ds = torch.tensor([True] * 6 + [False] * 2)
    toks, n = tspec.accept_rejection_batch(
        torch.from_numpy(lg), torch.from_numpy(drafts), seeds, steps, temps,
        tks, tps, ds, widths=torch.zeros(r, dtype=torch.int64))
    plain = tsmp.sample_batch(torch.from_numpy(lg[:, 0]), seeds, steps,
                              temps, tks, tps, ds)
    assert n.tolist() == [1] * r
    assert toks[:, 0].tolist() == plain.tolist()


# ---- the engine ---------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on one tiny-llama f32 tree."""
    jcfg = jax_config("tiny-llama").replace(dtype="float32",
                                            attn_backend="xla")
    params = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    cfg = get_config("tiny-llama").replace(dtype="float32")
    port = InferenceEngine(cfg, params_from_jax(tree, cfg, "cpu"),
                           max_seq=128, device="cpu")
    return JaxEngine(jcfg, params, max_seq=128), port


def _prompts():
    rng = np.random.default_rng(0)
    pattern = rng.integers(0, 256, 5).tolist()
    return {"repetitive": (pattern * 4)[:18],
            "random": rng.integers(0, 256, 13).tolist()}


@pytest.mark.parametrize("kind,gamma,eos_at", [
    ("repetitive", 3, None), ("random", 3, None), ("repetitive", 3, 5)])
def test_engine_speculative_greedy_matches_jax(monkeypatch, engines, kind,
                                               gamma, eos_at):
    monkeypatch.setenv("DLI_SPEC_ADAPTIVE", "0")
    jeng, eng = engines
    prompt = _prompts()[kind]
    jsp = jsmp.SamplingParams.greedy()
    plain = jeng.generate([prompt], 24, jsp).tokens[0]
    eos = plain[eos_at] if eos_at is not None else None
    if eos is not None:
        plain = jeng.generate([prompt], 24, jsp, eos_token_id=eos).tokens[0]
    jspec_toks = jeng.generate([prompt], 24, jsp, eos_token_id=eos,
                               speculative="ngram",
                               spec_gamma=gamma).tokens[0]
    streamed = []
    res = eng.generate([prompt], 24, GREEDY, eos_token_id=eos,
                       speculative="ngram", spec_gamma=gamma,
                       stream_cb=lambda step, t: streamed.append(t[0]))
    assert res.tokens[0] == plain == jspec_toks
    assert streamed == res.tokens[0]
    if kind == "repetitive" and eos is None:
        assert res.steps < len(res.tokens[0])   # drafts were accepted


def test_engine_speculative_adaptive_keeps_greedy_tokens(engines):
    """With the adaptive controller on (plain chunks interleaved), greedy
    tokens stay the plain ones."""
    _, eng = engines
    prompt = _prompts()["random"]
    plain = eng.generate([prompt], 40, GREEDY).tokens[0]
    assert eng.generate([prompt], 40, GREEDY, speculative="ngram",
                        spec_gamma=4).tokens[0] == plain


def test_engine_speculative_refusals(engines):
    _, eng = engines
    with pytest.raises(ValueError, match="unknown speculative"):
        eng.generate([[1, 2, 3]], 4, GREEDY, speculative="medusa")
    with pytest.raises(ValueError, match="one sequence"):
        eng.generate([[1, 2, 3], [4, 5]], 4, GREEDY, speculative="ngram")
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate([[1] * 100], 25, GREEDY, speculative="ngram",
                     spec_gamma=4)
    # (a tp engine serves speculation: tests/test_torch_tp_batcher.py)


@pytest.mark.parametrize("draft", ["likely", "unlikely"])
def test_verify_step_keeps_the_sampled_distribution(engines, draft):
    """The engine's verify step on 600 rows of one context, each drawing
    from its own stream: the first emitted token's frequencies against
    the exact target ``softmax(warp_logits)`` at that position (total
    variation under 0.1; the sampling noise of 600 draws over a top-8
    support is ~0.05), with the draft the most likely token or one
    outside the support; and a seeded speculative generation repeats."""
    from distributed_llm_inferencing_tpu_torch.ops.kvcache import init_cache
    from distributed_llm_inferencing_tpu_torch.ops.speculative import (
        verify_step)
    _, eng = engines
    model, cfg = eng.model, eng.cfg
    prompt = _prompts()["random"]
    sp = tsmp.SamplingParams(temperature=1.2, top_k=8, top_p=0.95)
    n = 600
    with torch.inference_mode():
        cache = init_cache(cfg, n, 32, device="cpu")
        toks = torch.tensor([prompt[:-1]] * n)
        lens = torch.full((n,), len(prompt) - 1, dtype=torch.int32)
        _, cache = model.prefill(toks, lens, cache)
        last, _ = model.prefill(torch.tensor([prompt]),
                                torch.tensor([len(prompt)]),
                                init_cache(cfg, 1, 32, device="cpu"),
                                gather=torch.tensor([len(prompt) - 1]))
        target = torch.softmax(tsmp.warp_logits(last[0, 0], sp), dim=-1)
        d = (int(target.argmax()) if draft == "likely"
             else int(target.argmin()))
        out, _ = verify_step(model, cache, torch.full((n,), prompt[-1]),
                             torch.tensor([[d, d]] * n),
                             (tsmp.row_seeds(9, n), torch.tensor([1])), sp)
    freq = torch.bincount(out[:, 0], minlength=cfg.vocab_size).float() / n
    tv = float((freq - target).abs().sum()) / 2
    assert tv < 0.1, (tv, draft)
    a = eng.generate([prompt], 15, sp, seed=7, speculative="ngram").tokens
    assert a == eng.generate([prompt], 15, sp, seed=7,
                             speculative="ngram").tokens
    assert len(a[0]) == 15
