"""The decode programs (runtime/graphs.py): static-buffer decode steps,
captured as CUDA graphs on a card, run eagerly here.

CPU (tiny-llama f32, weights bridged from the JAX tree):

- the engine's static-buffer step gives the JAX engine's greedy tokens
  exactly on its three decode loops (no eos, eos, stream), and the
  batcher's gives the JAX batcher's (an eos-stopped slot among them);
- the engine's per-batch-size state kept across requests (a long
  prompt, a short one, another batch size, the first again, and with a
  keep of one) gives a fresh engine's tokens, greedy and sampled;
- the counter-based engine sampler: draws inside the reference's
  ``warp_logits`` support, reproducible per seed, each row of a call on
  its own stream;
- the engine's verify program, the batcher's speculative chunk and its
  overlapped pairs through the stand-in capture: the eager tokens;
- the capture/replay control flow through stand-ins for the graph: one
  whose capture records the step's launches without running anything
  (launch accounting: counts equal the eager loop's, the capture adds
  none, a thread beside a capture keeps its own counts), and one that
  replays by running the step (the engine and batcher give the eager
  tokens through warm-up, capture and replays);
- FIFO eviction per batch size, release with an evicted batch size, on
  ``close``/``stop`` and on the worker's ``/unload_model`` (a released
  program raises), ``/health`` stats; cuBLAS's workspaces dropped only
  by the last owner of programs on a card.

CUDA (marked ``cuda``, skipped without a card; hd 32, since tiny-llama's
hd 8 is below the MMA tile): graphs on and off give the same tokens and
the same launch counts, engine (bf16 and int4) and batched (paged and
fused route), the captured speculative chunk (no decode kernel) and
overlapped pairs (the single-chunk path's tokens); replays count
exactly; after an unload a replay raises,
the device memory is back and the graphs' pool is gone; unloading one
model while another serves and captures leaves the other's tokens
alone; a kernel library's first load and launch on another thread, in
the middle of a capture, leaves both the capture and the launch right.
On a GPU machine:
``python -m pytest --noconftest tests/test_torch_graphs.py -m cuda``.
JAX is imported inside the CPU fixtures only: the card's machine has
none.
"""

import gc
import threading
import weakref

import numpy as np
import pytest
import requests
import torch

from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.models.registry import (
    get_config, register)
from distributed_llm_inferencing_tpu_torch.ops import (
    flash_attention as fa, launches, quant_matmul as qm)
from distributed_llm_inferencing_tpu_torch.ops import sampling as tsmp
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.runtime import graphs, lockstep
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from distributed_llm_inferencing_tpu_torch.runtime.worker import WorkerAgent

PROMPTS = [[3, 17, 52, 9, 1, 30, 44], list(range(5, 45))]   # buckets 16, 64
GREEDY = SamplingParams.greedy()
SAMPLED = SamplingParams(temperature=0.9, top_k=20, top_p=0.9)


@pytest.fixture(scope="module")
def jax_tree():
    import jax
    import jax.numpy as jnp
    from distributed_llm_inferencing_tpu.models.params import init_params
    from distributed_llm_inferencing_tpu.models.registry import get_config \
        as jax_config
    jcfg = jax_config("tiny-llama").replace(dtype="float32",
                                            attn_backend="xla")
    params = init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_engine(jax_tree):
    from distributed_llm_inferencing_tpu.runtime.engine import (
        InferenceEngine as JaxEngine)
    jcfg, params, _ = jax_tree
    return JaxEngine(jcfg, params, max_seq=96)


def _cfg():
    return get_config("tiny-llama").replace(dtype="float32")


def _engine(np_params, **kw):
    return InferenceEngine(_cfg(), params_from_jax(np_params, _cfg(), "cpu"),
                           max_seq=96, device="cpu", **kw)


@pytest.fixture(scope="module")
def engine(jax_tree):
    return _engine(jax_tree[2])


def _jax_greedy(jeng, prompts, **kw):
    from distributed_llm_inferencing_tpu.ops.sampling import SamplingParams \
        as JaxSamplingParams
    return jeng.generate(prompts, max_new_tokens=12,
                         sampling=JaxSamplingParams.greedy(), **kw).tokens


# ---- the engine's static-buffer step against the JAX engine -----------

@pytest.mark.parametrize("path", ["plain", "eos", "stream"])
def test_engine_program_greedy_matches_jax_engine(jax_engine, engine, path):
    prompts = PROMPTS
    kw, jkw, events = {}, {}, []
    if path == "eos":
        eos = _jax_greedy(jax_engine, prompts)[1][5]
        kw = jkw = {"eos_token_id": eos}
    elif path == "stream":
        kw = {"stream_cb": lambda step, toks: events.append((step, toks))}
    ref = _jax_greedy(jax_engine, prompts, **jkw)
    res = engine.generate(prompts, max_new_tokens=12, sampling=GREEDY, **kw)
    assert res.tokens == ref
    if path == "stream":
        assert [s for s, _ in events] == list(range(12))
        assert [list(t) for t in zip(*(toks for _, toks in events))] == ref
    st = engine.stats()
    assert st["decode_programs"] >= 1 and st["decode_graphs_captured"] == 0


# ---- the batcher's static buffers against the JAX batcher -------------

def _drive(b, prompts, eos=None, max_new=12, steps=300):
    reqs = [b.submit(p, max_new_tokens=max_new, sampling=GREEDY, seed=50 + i,
                     eos_token_id=eos[i] if eos else None)
            for i, p in enumerate(prompts)]
    for _ in range(steps):
        b.step()
        if all(r.done.is_set() for r in reqs):
            break
    return [r.wait() for r in reqs]


def _batcher_prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(0, 256, n).tolist() for n in (20, 9, 13)]


def test_batcher_program_greedy_matches_jax_batcher(jax_tree):
    from distributed_llm_inferencing_tpu.runtime.batcher import (
        ContinuousBatcher as JaxBatcher)
    jcfg, params, np_params = jax_tree
    args = dict(num_blocks=64, block_size=8, slots=4, max_seq=96, seed=0)
    jb = JaxBatcher(jcfg, params, **args)
    jb.DECODE_CHUNKS = (4,)
    free = _drive(jb, _batcher_prompts())
    # slot 1 stops mid-chunk, at the first token not seen before step 5
    j = next(j for j in range(5, 12) if free[1][j] not in free[1][:j])
    eos = [None, free[1][j], None]
    ref = _drive(jb, _batcher_prompts(), eos)
    assert ref[1] == free[1][:j]
    tb = ContinuousBatcher(_cfg(), params_from_jax(np_params, _cfg(), "cpu"),
                           device="cpu", **args)
    tb.DECODE_CHUNKS = (4,)
    assert _drive(tb, _batcher_prompts()) == free
    assert _drive(tb, _batcher_prompts(), eos) == ref
    assert tb.stats()["decode_programs"] == 1
    assert tb.warm_decode_programs() == 0          # no graphs on the CPU


# ---- the engine's kept state ------------------------------------------

def test_kept_engine_state_gives_a_fresh_engines_tokens(jax_tree):
    np_params = jax_tree[2]
    long_, short = PROMPTS[1], PROMPTS[0]
    calls = [([long_], GREEDY, 0), ([short], GREEDY, 0),
             ([short, long_], SAMPLED, 3), ([long_], SAMPLED, 7),
             ([short], GREEDY, 0)]

    def fresh(prompts, sp, seed):
        return _engine(np_params).generate(prompts, max_new_tokens=10,
                                           sampling=sp, seed=seed).tokens

    want = [fresh(*c) for c in calls]
    for keep in (2, 1):
        eng = _engine(np_params)
        eng.ROWS_KEPT = keep
        got = [eng.generate(p, max_new_tokens=10, sampling=sp,
                            seed=seed).tokens for p, sp, seed in calls]
        assert got == want, keep
        assert len(eng._rows) == keep
        # programs live only for the batch sizes kept
        kept = [p for st in eng._rows.values() for p in st.programs.values()]
        assert set(eng.programs.programs()) == set(kept)


# ---- the counter-based engine sampler ---------------------------------

@pytest.mark.parametrize("params", [
    dict(temperature=0.8, top_k=50, top_p=0.95),
    dict(temperature=0.7, top_k=0, top_p=0.5),
    dict(temperature=1.3, top_k=0, top_p=1.0),
])
def test_engine_sampler_support_seed_and_rows(params):
    import jax.numpy as jnp
    from distributed_llm_inferencing_tpu.ops import sampling as jsmp
    rng = np.random.default_rng(1)
    lg = rng.normal(size=(6, 300)).astype(np.float32) * 3.0
    lg[0] = lg[1] = rng.normal(size=300) * 0.3     # one broad row twice
    sp = SamplingParams(**params)
    support = np.isfinite(np.asarray(jsmp.warp_logits(
        jnp.asarray(lg), jsmp.SamplingParams(**params))))
    seeds = tsmp.row_seeds(21, 6)
    draws = []
    for step in range(120):
        key = (seeds, torch.tensor([step]))
        tok = tsmp.sample(torch.from_numpy(lg), key, sp)
        assert support[np.arange(6), tok.numpy()].all()
        # the same (seed, row, step) draws the same token, alone or not
        again = tsmp.sample(torch.from_numpy(lg[3:4]),
                            (seeds[3:4], torch.tensor([step])), sp)
        assert again[0] == tok[3]
        draws.append(tok.numpy())
    draws = np.stack(draws)
    # rows 0 and 1 share their logits, not their stream
    assert (draws[:, 0] != draws[:, 1]).mean() > 0.3
    assert np.array_equal(draws[:, 0], np.stack([
        tsmp.sample(torch.from_numpy(lg), (tsmp.row_seeds(21, 6),
                                           torch.tensor([s])), sp)[0]
        for s in range(120)]))
    other = tsmp.sample(torch.from_numpy(lg), (tsmp.row_seeds(22, 6),
                                               torch.tensor([0])), sp)
    assert not torch.equal(other, torch.from_numpy(draws[0]))


def test_rows_of_one_engine_call_draw_apart(engine):
    res = engine.generate([PROMPTS[0], PROMPTS[0]], max_new_tokens=12,
                          sampling=SamplingParams(temperature=1.5, top_k=0,
                                                  top_p=1.0), seed=4)
    assert res.tokens[0] != res.tokens[1]


# ---- capture and replay through stand-ins for the graph ---------------

class _Recorded:
    def __init__(self):
        self.resets = 0

    def replay(self):       # the device runs the kernels; no Python runs
        pass

    def reset(self):
        self.resets += 1


class _RecordingGraphs:
    """A capture that runs the step's Python, as a real capture does, to
    record its launches (the step below does nothing else)."""

    pool_bytes = 0

    def __init__(self, device):
        self.warms = 0

    def warm(self, step):
        self.warms += 1
        step()

    def capture(self, step):
        step()
        return _Recorded()


L = 3


def _fake_step():
    """One decode step's launches: L flash_decode, L + 1 q4_matmul in the
    tensor-core form."""
    for _ in range(L):
        launches.count(fa.flash_decode)
        launches.count(qm.q4_matmul, mma=True)
    launches.count(qm.q4_matmul, mma=True)


def test_replays_count_what_the_eager_loop_counts():
    def run(capture, n):
        lockstep.reset_launch_counts()
        progs = graphs.DecodePrograms(torch.device("cpu"),
                                      graphs_cls=_RecordingGraphs)
        prog = progs.make(_fake_step, capture)
        seen = []
        for _ in range(n):
            prog()
            seen.append(lockstep.launch_counts())
        return seen, prog

    eager, _ = run(False, 5)
    replayed, prog = run(True, 5)
    assert replayed == eager
    assert eager[0]["flash_decode"] == L and eager[-1]["flash_decode"] == 5 * L
    assert eager[-1]["q4_matmul[mma]"] == eager[-1]["q4_matmul"] == 5 * (L + 1)
    assert prog.captured and prog.replays == 4 and prog.capture_s >= 0
    assert prog.record == {(fa.flash_decode, "launches"): L,
                           (qm.q4_matmul, "launches"): L + 1,
                           (qm.q4_matmul, "launches_mma"): L + 1}
    lockstep.reset_launch_counts()


def test_a_thread_beside_a_capture_keeps_its_counts():
    lockstep.reset_launch_counts()
    inside = threading.Event()
    go = threading.Event()

    def other():
        inside.wait(10)
        launches.count(fa.flash_attention, mma=True)
        go.set()

    t = threading.Thread(target=other)
    t.start()
    with launches.recording() as rec:
        launches.count(fa.flash_decode)
        inside.set()
        assert go.wait(10)
    t.join(10)
    assert not t.is_alive()
    counts = lockstep.launch_counts()
    assert counts["flash_attention"] == counts["flash_attention[mma]"] == 1
    assert counts["flash_decode"] == 0
    assert rec == {(fa.flash_decode, "launches"): 1}
    lockstep.reset_launch_counts()


class _Replayed:
    def __init__(self, step):
        self.step = step

    def replay(self):       # the kernels run, their Python counts do not
        with launches.recording():
            self.step()

    def reset(self):
        self.step = None


class _ReplayingGraphs:
    """A capture that keeps the step without running it; each replay runs
    it, as a real graph's replay runs its kernels."""

    pool_bytes = 0

    def __init__(self, device):
        pass

    def warm(self, step):
        step()

    def capture(self, step):
        return _Replayed(step)


def test_captured_flow_gives_the_eager_tokens(monkeypatch, jax_tree,
                                              jax_engine):
    np_params = jax_tree[2]
    eng = _engine(np_params)
    eng.programs._graphs_cls = _ReplayingGraphs
    monkeypatch.setattr(graphs, "enabled", lambda device: True)
    ref = _jax_greedy(jax_engine, PROMPTS)
    assert eng.generate(PROMPTS, max_new_tokens=12,
                        sampling=GREEDY).tokens == ref
    streamed = eng.generate(PROMPTS, max_new_tokens=12, sampling=GREEDY,
                            stream_cb=lambda *a: None)
    assert streamed.tokens == ref
    sampled = eng.generate(PROMPTS, max_new_tokens=12, sampling=SAMPLED,
                           seed=5).tokens
    assert eng.stats()["decode_graphs_captured"] == 2
    monkeypatch.setattr(graphs, "enabled", lambda device: False)
    assert eng.generate(PROMPTS, max_new_tokens=12, sampling=SAMPLED,
                        seed=5).tokens == sampled
    assert eng.stats()["decode_programs"] == 3

    args = dict(num_blocks=64, block_size=8, slots=4, max_seq=96, seed=0,
                device="cpu")
    out = []
    for captured in (True, False):
        monkeypatch.setattr(graphs, "enabled", lambda device: captured)
        b = ContinuousBatcher(_cfg(), params_from_jax(np_params, _cfg(),
                                                      "cpu"), **args)
        b.programs._graphs_cls = _ReplayingGraphs
        b.DECODE_CHUNKS = (8, 4, 2, 1)
        assert b.warm_decode_programs() == int(captured)
        out.append(_drive(b, _batcher_prompts()))
        assert b.stats()["decode_graphs_captured"] == int(captured)
    assert out[0] == out[1]


def test_captured_speculative_flow_gives_the_eager_tokens(monkeypatch,
                                                         jax_tree):
    """The engine's verify program and the batcher's speculative chunk
    (adaptive off) and overlapped pairs through the stand-in capture give
    the eager tokens, sampled included; a speculative batcher warms two
    programs (the plain step and the chunk's iteration)."""
    np_params = jax_tree[2]
    monkeypatch.setenv("DLI_SPEC_ADAPTIVE", "0")
    rep = ([5, 9, 13, 2] * 5)[:18]
    out = {}
    for captured in (True, False):
        monkeypatch.setattr(graphs, "enabled", lambda device: captured)
        eng = _engine(np_params)
        eng.programs._graphs_cls = _ReplayingGraphs
        toks = [eng.generate([rep], max_new_tokens=12, sampling=sp,
                             seed=4, speculative="ngram",
                             spec_gamma=3).tokens
                for sp in (GREEDY, SAMPLED)]
        assert eng.stats()["decode_graphs_captured"] == 2 * int(captured)
        b = ContinuousBatcher(_cfg(), params_from_jax(np_params, _cfg(),
                                                      "cpu"),
                              num_blocks=64, block_size=8, slots=4,
                              max_seq=96, seed=0, device="cpu",
                              speculative="ngram", spec_gamma=3,
                              spec_adaptive=False)
        b.programs._graphs_cls = _ReplayingGraphs
        b.DECODE_CHUNKS = (8, 4)
        assert b.warm_decode_programs() == 2 * int(captured)
        toks.append(_drive(b, _batcher_prompts()[:1] + [rep]))
        o = ContinuousBatcher(_cfg(), params_from_jax(np_params, _cfg(),
                                                      "cpu"),
                              num_blocks=64, block_size=8, slots=4,
                              max_seq=96, seed=0, device="cpu",
                              decode_chunk_cap=2)
        o.programs._graphs_cls = _ReplayingGraphs
        toks.append(_drive(o, _batcher_prompts()[:2], max_new=8))
        assert o.stats()["overlapped_dispatches"] > 0
        out[captured] = toks
    assert out[True] == out[False]


# ---- eviction and release ---------------------------------------------

def test_fifo_eviction_and_release(monkeypatch, jax_tree):
    eng = _engine(jax_tree[2])
    eng.programs._graphs_cls = _ReplayingGraphs
    monkeypatch.setattr(graphs, "enabled", lambda device: True)
    eng.PROGRAMS_MAX = 2
    sps = [GREEDY, SAMPLED, SamplingParams(temperature=0.5)]

    def gen(sp, prompts=PROMPTS[:1]):
        eng.generate(prompts, max_new_tokens=4, sampling=sp)

    gen(sps[0])
    [first] = eng.programs.programs()
    assert first.captured
    gen(sps[1])
    gen(sps[0])                                # kept: no new program
    assert eng.programs.programs()[0] is first
    gen(sps[2])                                # evicts GREEDY's, the oldest
    progs = eng.programs.programs()
    assert len(progs) == 2 and first not in progs
    with pytest.raises(RuntimeError, match="released"):
        first()
    gen(sps[0], PROMPTS)                       # batch size 2: its own
    assert len(eng.programs.programs()) == 3
    gen(sps[0], PROMPTS[:1] * 3)               # batch size 3 evicts 1's
    assert sorted(eng._rows) == [2, 3]
    assert all(p.released for p in progs)
    [last, _] = eng.programs.programs()
    eng.close()
    assert eng.programs.programs() == []
    with pytest.raises(RuntimeError, match="released"):
        last()


def test_only_the_last_owner_on_a_card_drops_cublas_workspaces(monkeypatch):
    drops = []
    monkeypatch.setattr(graphs, "_drop_cublas_workspaces",
                        lambda: drops.append(1))
    monkeypatch.setattr(graphs, "_owners", weakref.WeakSet())
    cuda = torch.device("cuda")
    a, b = graphs.DecodePrograms(cuda), graphs.DecodePrograms(cuda)
    cpu = graphs.DecodePrograms(torch.device("cpu"))
    a.release()                  # b's graphs may have baked any of them
    assert drops == [] and not graphs.drop_idle_cublas_workspaces()
    b.release()                  # the last owner on a card; cpu's is none
    assert drops == [1]
    cpu.release()
    assert drops == [1]
    c = graphs.DecodePrograms(cuda)
    assert not graphs.drop_idle_cublas_workspaces()
    del c                        # an owner gone unreleased counts no more
    gc.collect()
    assert graphs.drop_idle_cublas_workspaces() and drops == [1, 1]


def test_unload_releases_the_programs(jax_tree):
    w = WorkerAgent(device="cpu")
    w.serve("127.0.0.1", 0, background=True)
    url = f"http://127.0.0.1:{w.service.port}"
    try:
        for serving in ("engine", "batched"):
            body = {"model_name": "tiny-llama", "allow_random_init": True,
                    "dtype": "float32", "max_seq": 64, "serving": serving,
                    "kv_blocks": 32, "kv_block_size": 8, "slots": 2}
            assert requests.post(url + "/load_model", json=body,
                                 timeout=60).status_code == 200
            r = requests.post(url + "/inference", json={
                "model_name": "tiny-llama", "prompt_tokens": PROMPTS[0],
                "max_new_tokens": 5}, timeout=60)
            assert r.status_code == 200, r.text
            [m] = requests.get(url + "/health", timeout=30).json()[
                "loaded_models"]
            stats = m if serving == "engine" else m["scheduler"]
            assert stats["decode_programs"] == 1
            assert stats["decode_graphs_captured"] == 0
            lm = w.models["tiny-llama"]
            owner = lm.engine or lm.batcher
            [prog] = owner.programs.programs()
            assert requests.post(url + "/unload_model", json={
                "model_name": "tiny-llama"}, timeout=60).status_code == 200
            assert owner.programs.programs() == []
            with pytest.raises(RuntimeError, match="released"):
                prog()
            del lm, owner, prog
    finally:
        w.shutdown()


# ---- on the card --------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cuda_cfg(quant=None):
    return get_config("tiny-llama").replace(
        name="graphs-llama", hidden_size=256, intermediate_size=512,
        num_heads=8, num_kv_heads=4, head_dim=32, num_layers=2,
        dtype="bfloat16", quant=quant, max_position_embeddings=512)


def _graphs_env(monkeypatch, on):
    monkeypatch.setenv("DLI_CUDA_GRAPHS", "1" if on else "0")


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int4"])
def test_cuda_engine_graphs_on_and_off_agree(monkeypatch, quant):
    _cuda()
    eng = InferenceEngine(_cuda_cfg(quant), max_seq=256, device="cuda",
                          seed=1)
    L = eng.cfg.num_layers
    out = {}
    for on in (True, False, True):
        _graphs_env(monkeypatch, on)
        rows = []
        for prompts, sp, kw in (
                ([PROMPTS[1]], GREEDY, {}), ([PROMPTS[1]], SAMPLED, {}),
                (PROMPTS, GREEDY, {"eos_token_id": 7}),
                (PROMPTS, SAMPLED, {"stream_cb": lambda *a: None})):
            lockstep.reset_launch_counts()
            res = eng.generate(prompts, max_new_tokens=20, sampling=sp,
                               seed=3, **kw)
            counts = lockstep.launch_counts()
            assert counts["flash_decode"] == L * (res.steps - 1)
            rows.append((res.tokens, counts))
        out.setdefault(on, []).append(rows)
    assert out[True][0] == out[False][0] == out[True][1]
    assert eng.stats()["decode_graphs_captured"] == 4   # (B, sp) x 2
    eng.close()


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_batcher_graphs_on_and_off_agree(monkeypatch, fused):
    _cuda()
    monkeypatch.setenv("DLI_FUSED_DECODE", "1" if fused else "0")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, n).tolist() for n in (40, 9, 100, 23)]
    out = {}
    for on in (True, False):
        _graphs_env(monkeypatch, on)
        b = ContinuousBatcher(_cuda_cfg(), num_blocks=128, block_size=16,
                              slots=4, max_seq=256, seed=1, device="cuda")
        assert b.warm_decode_programs() == int(on)
        lockstep.reset_launch_counts()
        reqs = [b.submit(p, max_new_tokens=24, seed=i,
                         sampling=GREEDY if i % 2 else SAMPLED)
                for i, p in enumerate(prompts)]
        for _ in range(200):
            b.step()
            if all(r.done.is_set() for r in reqs):
                break
        counts = lockstep.launch_counts()
        passes = b.metrics.snapshot()["counters"]["batcher_weight_passes"]
        kernel = "fused_decode_step" if fused else "paged_flash_decode"
        assert counts[kernel] == b.cfg.num_layers * passes
        out[on] = ([r.wait() for r in reqs], counts, passes)
        assert b.stats()["decode_graphs_captured"] == int(on)
        b.stop()
    assert out[True] == out[False]


@pytest.mark.cuda
def test_cuda_unload_frees_the_graphs_and_refuses_a_replay():
    _cuda()
    gc.collect()
    # no cuBLAS workspace in the baseline: the unload cannot pass by
    # dropping one made before the load
    assert graphs.drop_idle_cublas_workspaces()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    register(_cuda_cfg())     # the worker loads by name
    w = WorkerAgent(device="cuda")
    w.serve("127.0.0.1", 0, background=True)
    url = f"http://127.0.0.1:{w.service.port}"
    try:
        for serving in ("engine", "batched"):
            assert requests.post(url + "/load_model", json={
                "model_name": "graphs-llama", "allow_random_init": True,
                "dtype": "bfloat16", "max_seq": 128, "serving": serving,
                "kv_blocks": 32, "kv_block_size": 16, "slots": 2},
                timeout=120).status_code == 200
            lockstep.reset_launch_counts()
            r = requests.post(url + "/inference", json={
                "model_name": "graphs-llama", "prompt_tokens": PROMPTS[1],
                "max_new_tokens": 8}, timeout=120)
            assert r.status_code == 200, r.text
            lm = w.models["graphs-llama"]
            owner = lm.engine or lm.batcher
            [prog] = owner.programs.programs()
            assert prog.captured and prog.replays >= 1
            pool = owner.programs.pool
            assert requests.post(url + "/unload_model", json={
                "model_name": "graphs-llama"}, timeout=120).status_code == 200
            with pytest.raises(RuntimeError, match="released"):
                prog()
            del lm, owner, prog
            gc.collect()
            torch.cuda.synchronize()
            assert torch.cuda.memory_allocated() <= before, serving
            torch.cuda.empty_cache()
            assert not [seg for seg in torch.cuda.memory_snapshot()
                        if tuple(seg["segment_pool_id"]) == pool], serving
    finally:
        w.shutdown()


@pytest.mark.cuda
def test_cuda_unloading_a_model_leaves_anothers_graphs_alone(monkeypatch):
    """Model b serves on a thread, capturing a program per new sampling
    config, while models are loaded, captured and unloaded beside it:
    b's tokens must be those it gives with graphs off."""
    _cuda()
    _graphs_env(monkeypatch, True)
    b = InferenceEngine(_cuda_cfg(), max_seq=256, device="cuda", seed=2)
    done, calls = threading.Event(), []

    def serve():
        i = 0
        while not done.is_set() or i < 8:
            sp = SamplingParams(temperature=0.5 + 0.05 * i, top_k=20)
            calls.append((sp, b.generate([PROMPTS[1]], max_new_tokens=16,
                                         sampling=sp, seed=i).tokens))
            i += 1

    t = threading.Thread(target=serve)
    t.start()
    try:
        for i in range(4):
            a = InferenceEngine(_cuda_cfg("int4" if i % 2 else None),
                                max_seq=256, device="cuda", seed=1)
            a.generate([PROMPTS[0]], max_new_tokens=16, sampling=GREEDY)
            a.close()             # while b serves and captures
            del a
    finally:
        done.set()
        t.join(300)
    assert not t.is_alive()
    assert b.stats()["decode_graphs_captured"] == len(calls)
    _graphs_env(monkeypatch, False)
    for i, (sp, tokens) in enumerate(calls):
        assert b.generate([PROMPTS[1]], max_new_tokens=16, sampling=sp,
                          seed=i).tokens == tokens, i
    b.close()


@pytest.mark.cuda
def test_cuda_first_kernel_load_beside_a_capture(monkeypatch, tmp_path):
    """A model loaded later launches its kernels for the first time while
    another owner may be capturing (ops/build.py loads a library at first
    use; the CUDA module itself loads at its first launch). Forced here:
    the engine's capture is paused inside torch.cuda.graph while another
    thread dlopens a fresh copy of the q4 kernels' library (a module this
    process never loaded) and launches it on its own stream. The launch
    must give the already-loaded library's bytes, the capture must still
    be open when the thread is done, and the captured program must replay
    the tokens the engine gives with graphs off."""
    import shutil
    from distributed_llm_inferencing_tpu_torch.ops import build
    from distributed_llm_inferencing_tpu_torch.ops import quant as tq
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((8, 512), generator=g, device=dev).bfloat16()
    leaf = tq.quantize_weight_int4(
        torch.randn((512, 768), generator=g, device=dev) * 0.05)
    want = qm.q4_matmul(x, leaf["p4"], leaf["scale"])    # loaded library
    torch.cuda.synchronize()
    fresh = tmp_path / "libquant_matmul-fresh.so"
    shutil.copyfile(build.library_path("quant_matmul"), fresh)
    real_path = build.library_path
    monkeypatch.setattr(build, "library_path", lambda name: str(fresh)
                        if name == "quant_matmul" else real_path(name))
    monkeypatch.setattr(qm, "_lib", None)
    monkeypatch.delitem(build._libs, "quant_matmul", raising=False)

    started, loaded, out = threading.Event(), threading.Event(), {}

    def first_load():
        try:
            assert started.wait(120)
            s = torch.cuda.Stream(dev)
            with torch.cuda.stream(s):
                out["got"] = qm.q4_matmul(x, leaf["p4"], leaf["scale"])
            s.synchronize()
            out["lib"] = qm._lib
        except BaseException as e:   # reported on the main thread
            out["error"] = e
        finally:
            loaded.set()

    real_capture = graphs.CudaGraphs.capture

    def paused_capture(self, step):
        def paused():
            started.set()
            assert loaded.wait(120)
            out["capturing"] = torch.cuda.is_current_stream_capturing()
            step()
        return real_capture(self, paused)

    monkeypatch.setattr(graphs.CudaGraphs, "capture", paused_capture)
    _graphs_env(monkeypatch, True)
    eng = InferenceEngine(_cuda_cfg(), max_seq=256, device="cuda", seed=1)
    t = threading.Thread(target=first_load)
    t.start()
    try:
        on = eng.generate([PROMPTS[1]], max_new_tokens=16, sampling=GREEDY)
    finally:
        started.set()
        t.join(300)
    assert not t.is_alive() and "error" not in out, out.get("error")
    assert out["capturing"] is True
    assert out["lib"]._name == str(fresh)
    assert torch.equal(out["got"], want)
    assert eng.stats()["decode_graphs_captured"] == 1
    again = eng.generate([PROMPTS[1]], max_new_tokens=16, sampling=GREEDY)
    _graphs_env(monkeypatch, False)
    off = eng.generate([PROMPTS[1]], max_new_tokens=16, sampling=GREEDY)
    assert on.tokens == again.tokens == off.tokens
    eng.close()


@pytest.mark.cuda
def test_cuda_speculative_chunk_graphs_on_and_off_agree(monkeypatch):
    """The captured speculative chunk (wave on, adaptive off: every chunk
    speculative) gives the eager tokens, greedy and sampled, and no
    decode kernel launches; its warm-up captures two programs."""
    _cuda()
    monkeypatch.setenv("DLI_FUSED_DECODE", "0")
    rng = np.random.default_rng(4)
    phrase = rng.integers(1, 256, 6).tolist()
    prompts = [(phrase * 8)[:40], rng.integers(1, 256, 9).tolist(),
               (phrase * 20)[:100], rng.integers(1, 256, 23).tolist()]
    out = {}
    for on in (True, False):
        _graphs_env(monkeypatch, on)
        b = ContinuousBatcher(_cuda_cfg(), num_blocks=128, block_size=16,
                              slots=4, max_seq=256, seed=1, device="cuda",
                              speculative="ngram", spec_gamma=4,
                              spec_adaptive=False)
        assert b.warm_decode_programs() == 2 * int(on)
        lockstep.reset_launch_counts()
        reqs = [b.submit(p, max_new_tokens=40, seed=i,
                         sampling=GREEDY if i % 2 else SAMPLED)
                for i, p in enumerate(prompts)]
        for _ in range(200):
            b.step()
            if all(r.done.is_set() for r in reqs):
                break
        counts = lockstep.launch_counts()
        assert counts["paged_flash_decode"] == counts["flash_decode"] == 0
        out[on] = [r.wait() for r in reqs]
        assert b.stats()["spec_wave"]["dispatches"] > 0
        b.stop()
    assert out[True] == out[False]


@pytest.mark.cuda
def test_cuda_overlapped_pair_graphs_on_and_off_agree(monkeypatch):
    """Overlapped pairs (chunk B fed on the device by A's last tokens)
    captured and eager: the single-chunk path's tokens and exact
    launches, with pairs dispatched."""
    _cuda()
    monkeypatch.setenv("DLI_FUSED_DECODE", "0")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, n).tolist() for n in (40, 9, 100, 23)]
    out = {}
    for on, overlap in ((True, True), (False, True), (True, False)):
        _graphs_env(monkeypatch, on)
        b = ContinuousBatcher(_cuda_cfg(), num_blocks=128, block_size=16,
                              slots=4, max_seq=256, seed=1, device="cuda",
                              decode_chunk_cap=8, decode_overlap=overlap)
        lockstep.reset_launch_counts()
        reqs = [b.submit(p, max_new_tokens=40, seed=i,
                         sampling=GREEDY if i % 2 else SAMPLED)
                for i, p in enumerate(prompts)]
        for _ in range(200):
            b.step()
            if all(r.done.is_set() for r in reqs):
                break
        passes = b.metrics.snapshot()["counters"]["batcher_weight_passes"]
        assert lockstep.launch_counts()["paged_flash_decode"] == \
            b.cfg.num_layers * passes
        assert (b.stats()["overlapped_dispatches"] > 0) == overlap
        out[on, overlap] = [r.wait() for r in reqs]
        b.stop()
    assert out[True, True] == out[False, True] == out[True, False]
