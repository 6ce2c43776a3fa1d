"""The port's sampler against the JAX package's.

Greedy must be bitwise (argmax, first maximum on ties). Sampled draws
come from the port's counter-based stream (keyed on (seed, step) per row)
and cannot reproduce jax.random's, so a sampled token is held to the
support of the reference's ``warp_logits``: it must never fall outside
temperature -> top-k -> top-p.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inferencing_tpu.ops import sampling as jsmp
from distributed_llm_inferencing_tpu_torch.ops import sampling as tsmp
from test_torch_families import one_torch_thread  # noqa: F401


def _logits(seed, shape=(4, 300)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_greedy_is_bitwise():
    lg = _logits(0)
    lg[1, 7] = lg[1, 9] = lg[1].max() + 1.0       # a tie: first index wins
    ref = jsmp.sample(jnp.asarray(lg), jax.random.PRNGKey(0),
                      jsmp.SamplingParams.greedy())
    out = tsmp.sample(torch.from_numpy(lg), None,
                      tsmp.SamplingParams.greedy())
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_params_defaults_match_reference():
    assert tsmp.SamplingParams() == tsmp.SamplingParams(
        **jsmp.SamplingParams().__dict__)


@pytest.mark.parametrize("params", [
    dict(temperature=0.8, top_k=50, top_p=0.95),
    dict(temperature=1.0, top_k=5, top_p=1.0),
    dict(temperature=0.7, top_k=0, top_p=0.5),
    dict(temperature=1.3, top_k=0, top_p=1.0),
])
def test_sampled_tokens_lie_in_reference_support(params):
    lg = _logits(1, (8, 500)) * 3.0
    jp, tp = jsmp.SamplingParams(**params), tsmp.SamplingParams(**params)
    support = np.isfinite(np.asarray(jsmp.warp_logits(jnp.asarray(lg), jp)))
    seeds = tsmp.row_seeds(11, 8)
    seen = set()
    for step in range(200):
        tok = tsmp.sample(torch.from_numpy(lg),
                          (seeds, torch.tensor([step])), tp).numpy()
        assert support[np.arange(8), tok].all()
        seen.update(zip(range(8), tok.tolist()))
    if params["top_k"] != 1:
        assert len(seen) > 8          # it does sample, not argmax


def test_same_seed_same_draws():
    lg = torch.from_numpy(_logits(2))
    sp = tsmp.SamplingParams(temperature=1.0, top_k=20, top_p=0.9)
    a, b, c = (tsmp.sample(lg, (tsmp.row_seeds(s, 4), torch.tensor([3])),
                           sp) for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_draw_frequencies_follow_the_distribution():
    probs = torch.tensor([[0.5, 0.3, 0.2, 0.0]])
    seeds = tsmp.row_seeds(0, 1)
    counts = torch.zeros(4)
    for step in range(4000):
        counts[tsmp._draw(probs, (seeds, torch.tensor([step])))[0, 0]] += 1
    assert counts[3] == 0
    np.testing.assert_allclose((counts / counts.sum()).numpy(),
                               probs[0].numpy(), atol=0.03)


# ---- sample_batch: the continuous batcher's per-row sampler -----------

def _batch_params(rows):
    """rows: (temp, top_k, top_p, do_sample) per row -> tensors."""
    t, k, p, d = zip(*rows)
    return (torch.tensor(t, dtype=torch.float32),
            torch.tensor(k, dtype=torch.int32),
            torch.tensor(p, dtype=torch.float32), torch.tensor(d))


ROWS = [(0.8, 50, 0.95, True), (1.0, 0, 0.5, True), (1.0, 1, 1.0, False),
        (1.3, 200, 1.0, True), (0.7, 5, 0.9, True), (1.0, 0, 1.0, False)]


def test_sample_batch_greedy_rows_match_jax():
    lg = _logits(3, (6, 400)) * 2.0
    lg[2, 11] = lg[2, 13] = lg[2].max() + 1.0          # a tie: first wins
    temps, tks, tps, ds = _batch_params(ROWS)
    seeds = np.arange(6, dtype=np.int32) + 40
    steps = np.zeros(6, np.int32)
    ref = jsmp.sample_batch(jnp.asarray(lg), jnp.asarray(seeds),
                            jnp.asarray(steps), jnp.asarray(temps.numpy()),
                            jnp.asarray(tks.numpy()),
                            jnp.asarray(tps.numpy()), jnp.asarray(ds.numpy()))
    out = tsmp.sample_batch(torch.from_numpy(lg), torch.from_numpy(seeds),
                            torch.from_numpy(steps), temps, tks, tps, ds)
    greedy = ~ds.numpy()
    np.testing.assert_array_equal(out.numpy()[greedy],
                                  np.asarray(ref)[greedy])


def test_nucleus_mask_sorted_matches_jax():
    vals = -np.sort(-_logits(4, (5, 64)), axis=-1)
    width = np.asarray([[64], [5], [1], [30], [64]])
    tps = np.asarray([[0.9], [1.0], [0.5], [0.3], [1.0]], np.float32)
    jm, jt = jsmp.nucleus_mask_sorted(jnp.asarray(vals), jnp.asarray(width),
                                      jnp.asarray(tps))
    tm, tt = tsmp.nucleus_mask_sorted(torch.from_numpy(vals),
                                      torch.from_numpy(width),
                                      torch.from_numpy(tps))
    np.testing.assert_array_equal(np.isfinite(tm.numpy()),
                                  np.isfinite(np.asarray(jm)))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)


def test_sample_batch_draws_lie_in_reference_support():
    lg = _logits(5, (6, 400)) * 3.0
    temps, tks, tps, ds = _batch_params(ROWS)
    support = np.stack([
        np.isfinite(np.asarray(jsmp.warp_logits(
            jnp.asarray(lg[i:i + 1]),
            jsmp.SamplingParams(temperature=r[0], top_k=r[1], top_p=r[2]))))
        [0] for i, r in enumerate(ROWS)])
    seeds = torch.arange(6, dtype=torch.int32) + 7
    seen = set()
    for step in range(150):
        tok = tsmp.sample_batch(torch.from_numpy(lg), seeds,
                                torch.full((6,), step, dtype=torch.int32),
                                temps, tks, tps, ds).numpy()
        for i in np.flatnonzero(ds.numpy()):
            assert support[i, tok[i]], (i, tok[i])
        seen.update((i, int(tok[i])) for i in range(6))
    assert len([s for s in seen if s[0] == 0]) > 1   # it does sample


def test_sample_batch_row_draw_depends_only_on_its_seed_step_logits():
    """The same (seed, step, logits row, params) gives the same token at
    any row index and whatever the chunk-mates: a request's tokens do not
    depend on how the batcher packs it."""
    lg = torch.from_numpy(_logits(6, (6, 400)) * 2.0)
    temps, tks, tps, ds = _batch_params(ROWS)
    seeds = torch.tensor([3, 9, 27, 81, 5, 1], dtype=torch.int32)
    steps = torch.tensor([0, 4, 2, 7, 1, 3], dtype=torch.int32)
    full = tsmp.sample_batch(lg, seeds, steps, temps, tks, tps, ds)
    perm = torch.tensor([4, 2, 0, 5, 1, 3])
    shuffled = tsmp.sample_batch(lg[perm], seeds[perm], steps[perm],
                                 temps[perm], tks[perm], tps[perm], ds[perm])
    assert torch.equal(shuffled, full[perm])
    noise = torch.from_numpy(_logits(7, (6, 400)))
    for i in range(6):                 # alone, and beside other rows
        alone = tsmp.sample_batch(lg[i:i + 1], seeds[i:i + 1],
                                  steps[i:i + 1], temps[i:i + 1],
                                  tks[i:i + 1], tps[i:i + 1], ds[i:i + 1])
        mates = torch.cat([noise[:2], lg[i:i + 1]])
        sel = [5 - i % 2, i, i]
        mixed = tsmp.sample_batch(mates, seeds[sel] + torch.tensor([1, 2, 0],
                                                                   dtype=torch.int32),
                                  steps[sel], temps[sel], tks[sel], tps[sel],
                                  ds[sel])
        assert alone[0] == full[i] == mixed[2]


def test_sample_batch_frequencies_follow_the_distribution():
    """Counter-based draws over successive steps of one row follow the
    warped distribution (top-k 3 of 4 logits at temperature 1)."""
    lg = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]]))
    one = lambda v, dt: torch.tensor([v], dtype=dt)  # noqa: E731
    counts = torch.zeros(4)
    for step in range(3000):
        tok = tsmp.sample_batch(lg, one(11, torch.int32),
                                one(step, torch.int32),
                                one(1.0, torch.float32), one(3, torch.int32),
                                one(1.0, torch.float32), one(True, torch.bool))
        counts[tok[0]] += 1
    assert counts[3] == 0
    np.testing.assert_allclose((counts[:3] / counts.sum()).numpy(),
                               np.asarray([0.5, 0.3, 0.15]) / 0.95,
                               atol=0.03)
