"""The port's worker agent over real sockets, on the CPU path.

Starts the worker on a localhost port with ``device="cpu"`` and drives
the routes the JAX worker also serves: /health, /load_model,
/inference, /unload_model — including the 400s for request fields this
slice does not implement.

Checkpoints (``checkpoint_path``, ``native_checkpoint``): the tiny HF
llama of test_torch_convert.py, loaded by the port's worker and by a JAX
worker beside it on the same socket API, must give the same greedy
tokens in engine and batched mode, with float, int8 and int4 weights
(``"dtype": "float32"``: both compute in f32 on weights converted to
bf16 first, the JAX worker's order, held here too); a native checkpoint
written by the port's ``convert`` CLI loads with the same bytes and
tokens as the HF directory it came from; and each checkpoint the port
cannot serve gets a 400 that names the cause.
"""

import os
import subprocess
import sys

import jax
import pytest
import requests
import torch

from distributed_llm_inferencing_tpu.models.checkpoint import (
    save_checkpoint as jax_save_checkpoint)
from distributed_llm_inferencing_tpu.models.params import (
    init_params as jax_init_params)
from distributed_llm_inferencing_tpu.models.registry import (
    get_config as jax_config)
from distributed_llm_inferencing_tpu.runtime.worker import (
    WorkerAgent as JaxWorkerAgent)
from distributed_llm_inferencing_tpu_torch.runtime.worker import WorkerAgent
from test_torch_convert import (
    EXPERT_TYPES, TYPES, _ROOT, assert_bitwise, jax_params, saved,
    with_tokenizer)
from test_torch_families import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def worker():
    w = WorkerAgent(device="cpu")
    w.serve("127.0.0.1", 0, background=True)
    yield w
    w.shutdown()


@pytest.fixture(scope="module")
def url(worker):
    return f"http://127.0.0.1:{worker.service.port}"


def test_health_reports_the_device(url):
    r = requests.get(url + "/health", timeout=30).json()
    assert r["status"] == "online"
    assert r["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert r["loaded_models"] == []


def test_load_infer_unload(url):
    r = requests.post(url + "/load_model", json={
        "model_name": "tiny-llama", "allow_random_init": True,
        "dtype": "float32", "max_seq": 64}, timeout=60)
    assert r.status_code == 200 and r.json()["status"] == "success"
    names = [m["name"] for m in
             requests.get(url + "/health", timeout=30).json()["loaded_models"]]
    assert names == ["tiny-llama"]

    body = {"model_name": "tiny-llama", "prompt_tokens": [5, 9, 13, 2],
            "max_new_tokens": 6, "seed": 3,
            "sampling": {"do_sample": False}}
    a = requests.post(url + "/inference", json=body, timeout=60).json()
    b = requests.post(url + "/inference", json=body, timeout=60).json()
    assert a["status"] == "success" and a["tokens"] == b["tokens"]
    assert 1 <= len(a["tokens"]) <= 6 and a["execution_time"] > 0
    assert isinstance(a["result"], str)
    assert a["cost"]["weight_passes"] >= len(a["tokens"])

    t = requests.post(url + "/inference", json={
        "model_name": "tiny-llama", "prompt": "hi", "max_new_tokens": 3,
        "seed": 1}, timeout=60).json()
    assert t["status"] == "success"

    r = requests.post(url + "/unload_model",
                      json={"model_name": "tiny-llama"}, timeout=30)
    assert r.status_code == 200
    r = requests.post(url + "/inference", json=body, timeout=30)
    assert r.status_code == 400


@pytest.mark.parametrize("extra", [
    {"serving": "batched", "speculative": "medusa"}, {"quantize": "int3"},
    {"embed_quantize": "int4"}, {"kv_quantize": "fp8"},
    {"dtype": "float16"},
])
def test_unported_load_fields_are_refused(url, extra):
    body = {"model_name": "tiny-llama", "allow_random_init": True, **extra}
    r = requests.post(url + "/load_model", json=body, timeout=30)
    assert r.status_code == 400 and r.json()["status"] == "error"


@pytest.mark.parametrize("serving", ["engine", "batched"])
def test_load_int4_and_infer(url, serving):
    """``"quantize": "int4"`` (+ the int8 embedding table) loads, reports
    its stored bytes and quantization on /health, and serves."""
    load = {"model_name": "tiny-llama", "allow_random_init": True,
            "dtype": "float32", "max_seq": 64, "serving": serving,
            "quantize": "int4", "embed_quantize": "int8", "kv_blocks": 32,
            "kv_block_size": 8, "slots": 2}
    r = requests.post(url + "/load_model", json=load, timeout=60)
    assert r.status_code == 200 and r.json()["status"] == "success", r.text
    [m] = requests.get(url + "/health", timeout=30).json()["loaded_models"]
    assert m["serving"] == serving and m["quantize"] == "int4"
    assert m["embed_quantize"] == "int8"
    # tiny-llama: 4 layers of D=64, I=128, q/kv widths 64/32, V=256;
    # int4 linears (half a byte + f32 scales), int8 table + row scales,
    # f32 norms
    D, I, V, L = 64, 128, 256, 4
    lin = [(D, 64), (D, 32), (D, 32), (64, D), (D, I), (D, I), (I, D)]
    want = (L * sum(din // 2 * dout + 4 * dout for din, dout in lin)
            + D // 2 * V + 4 * V + V * D + 4 * V + 4 * D * (2 * L + 1))
    assert m["param_bytes"] == want
    body = {"model_name": "tiny-llama", "prompt_tokens": [5, 9, 13, 2],
            "max_new_tokens": 6, "seed": 3,
            "sampling": {"do_sample": False}}
    a = requests.post(url + "/inference", json=body, timeout=60).json()
    b = requests.post(url + "/inference", json=body, timeout=60).json()
    assert a["status"] == "success" and a["tokens"] == b["tokens"]
    assert 1 <= len(a["tokens"]) <= 6
    r = requests.post(url + "/unload_model",
                      json={"model_name": "tiny-llama"}, timeout=30)
    assert r.status_code == 200


@pytest.mark.parametrize("extra", [{"speculative": "medusa"},
                                   {"adapter": "never-loaded"}])
def test_unported_inference_fields_are_refused(url, extra):
    requests.post(url + "/load_model", json={
        "model_name": "tiny-llama", "allow_random_init": True,
        "dtype": "float32", "max_seq": 64}, timeout=60)
    r = requests.post(url + "/inference", json={
        "model_name": "tiny-llama", "prompt_tokens": [1, 2],
        "max_new_tokens": 2, **extra}, timeout=30)
    assert r.status_code == 400
    requests.post(url + "/unload_model", json={"model_name": "tiny-llama"},
                  timeout=30)


# the JAX worker's 400s for the speculation fields of an /inference body
_SPEC_REFUSED = [
    ("engine", {"speculative": "medusa"}),
    ("engine", {"speculative": "ngram", "spec_gamma": 0}),
    ("engine", {"speculative": "ngram", "spec_gamma": 17}),
    ("engine", {"speculative": "ngram", "spec_gamma": "four"}),
    ("batched", {"speculative": "ngram"}),
]


@pytest.mark.parametrize("serving,extra", _SPEC_REFUSED)
def test_speculation_fields_refused_as_the_jax_worker_does(url, serving,
                                                           extra):
    requests.post(url + "/load_model", json={
        "model_name": "tiny-llama", "allow_random_init": True,
        "dtype": "float32", "max_seq": 64, "serving": serving,
        "kv_blocks": 32, "kv_block_size": 8, "slots": 2}, timeout=60)
    r = requests.post(url + "/inference", json={
        "model_name": "tiny-llama", "prompt_tokens": [1, 2],
        "max_new_tokens": 2, **extra}, timeout=30)
    assert r.status_code == 400 and r.json()["status"] == "error"
    requests.post(url + "/unload_model", json={"model_name": "tiny-llama"},
                  timeout=30)


def test_engine_speculation_serves_the_plain_greedy_tokens(url, jax_url):
    """An engine-mode /inference with ``speculative`` answers the greedy
    tokens of the same body without it, and both workers answer the
    engine-mode refusals above with a 400 (the JAX worker refuses them
    before it generates)."""
    load = {"model_name": "tiny-llama", "allow_random_init": True,
            "dtype": "float32", "max_seq": 96}
    base = {"model_name": "tiny-llama",
            "prompt_tokens": ([5, 9, 13, 2, 40, 7] * 4)[:22],
            "max_new_tokens": 16, "seed": 3,
            "sampling": {"do_sample": False}}
    for u in (url, jax_url):
        assert requests.post(u + "/load_model", json=load,
                             timeout=120).status_code == 200
        codes = [requests.post(u + "/inference", json=dict(base, **extra),
                               timeout=60).status_code
                 for serving, extra in _SPEC_REFUSED if serving == "engine"]
        assert codes == [400] * len(codes), (u, codes)
    plain = requests.post(url + "/inference", json=base, timeout=120)
    spec = requests.post(url + "/inference", json=dict(
        base, speculative="ngram", spec_gamma=3), timeout=120)
    assert plain.status_code == spec.status_code == 200, spec.text
    assert spec.json()["tokens"] == plain.json()["tokens"]
    for u in (url, jax_url):
        requests.post(u + "/unload_model", json={"model_name": "tiny-llama"},
                      timeout=30)


def test_out_of_vocab_prompt_is_refused(url):
    requests.post(url + "/load_model", json={
        "model_name": "tiny-llama", "allow_random_init": True,
        "dtype": "float32", "max_seq": 64}, timeout=60)
    for toks in ([5, 256], [-1, 3]):       # tiny-llama's vocab is 256
        r = requests.post(url + "/inference", json={
            "model_name": "tiny-llama", "prompt_tokens": toks,
            "max_new_tokens": 2}, timeout=30)
        assert r.status_code == 400
    requests.post(url + "/unload_model", json={"model_name": "tiny-llama"},
                  timeout=30)


def test_load_without_random_init_or_unknown_model(url):
    r = requests.post(url + "/load_model", json={"model_name": "tiny-llama"},
                      timeout=30)
    assert r.status_code == 400
    r = requests.post(url + "/load_model", json={
        "model_name": "no-such-model", "allow_random_init": True},
        timeout=30)
    assert r.status_code == 400


def test_cuda_is_the_default_device():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default resolves")
    with pytest.raises(RuntimeError):
        WorkerAgent()


# ---- checkpoints -------------------------------------------------------

@pytest.fixture(scope="module")
def jax_url():
    w = JaxWorkerAgent()
    w.serve("127.0.0.1", 0, background=True)
    yield f"http://127.0.0.1:{w.service.port}"
    w.service.shutdown()


def _load(url, body, status=200):
    r = requests.post(url + "/load_model", json=body, timeout=180)
    assert r.status_code == status, r.text
    return r.json()


def _greedy(url, name, new=8):
    r = requests.post(url + "/inference", json={
        "model_name": name, "prompt_tokens": [5, 9, 13, 2, 40, 7, 77, 3],
        "max_new_tokens": new, "seed": 1,
        "sampling": {"do_sample": False}}, timeout=120).json()
    assert r["status"] == "success", r
    return r["tokens"]


def _unload(url, name):
    r = requests.post(url + "/unload_model", json={"model_name": name},
                      timeout=60)
    assert r.status_code == 200, r.text


_POOL = {"kv_blocks": 64, "kv_block_size": 8, "slots": 2, "max_seq": 64}


@pytest.mark.parametrize("serving,quantize", [
    ("engine", None), ("engine", "int8"), ("engine", "int4"),
    ("batched", None), ("batched", "int4")])
def test_checkpoint_path_tokens_match_the_jax_worker(url, jax_url, serving,
                                                     quantize):
    d = saved("llama")
    name = f"ckpt-{serving}-{quantize}"
    body = {"model_name": name, "checkpoint_path": d, "dtype": "float32",
            "serving": serving, **_POOL,
            **({"quantize": quantize} if quantize else {})}
    for u in (url, jax_url):
        _load(u, body)
    [m] = [m for m in requests.get(url + "/health", timeout=30).json()[
        "loaded_models"] if m["name"] == name]
    assert m["source"] == d and m["serving"] == serving
    assert m["quantize"] == quantize
    try:
        got = _greedy(url, name)
        assert got == _greedy(jax_url, name) and len(got) == 8
    finally:
        for u in (url, jax_url):
            _unload(u, name)


@pytest.mark.parametrize("mt", TYPES[20:])
def test_later_types_serve_from_checkpoint_path(url, worker, mt):
    """Each converter type of the dense switches (gemma2, qwen3, ...)
    through /load_model with ``checkpoint_path`` (engine mode, bf16 as
    the JAX worker converts): params bitwise equal to the JAX
    converter's, and greedy /inference tokens equal to an in-process
    engine's on those params (test_torch_convert_tokens_c.py holds the
    engines and batchers to the JAX package's)."""
    from distributed_llm_inferencing_tpu_torch.ops.sampling import (
        SamplingParams)
    from distributed_llm_inferencing_tpu_torch.runtime.engine import (
        InferenceEngine)
    d = saved(mt)
    name = f"later-{mt}"
    _load(url, {"model_name": name, "checkpoint_path": d, "max_seq": 64})
    try:
        tcfg, want = jax_params(d, "bfloat16")
        assert_bitwise(worker.models[name].engine.params, want)
        eos = worker.models[name].tokenizer.eos_token_id
        ref = InferenceEngine(tcfg, want, max_seq=64, device="cpu").generate(
            [[5, 9, 13, 2, 40, 7, 77, 3]], max_new_tokens=8, seed=1,
            sampling=SamplingParams.greedy(), eos_token_id=eos).tokens[0]
        assert _greedy(url, name) == ref and ref
    finally:
        _unload(url, name)


@pytest.mark.parametrize("mt", list(EXPERT_TYPES))
def test_expert_types_serve_from_checkpoint_path(url, worker, mt):
    """Each experts or latent-attention converter type through
    /load_model with ``checkpoint_path`` in both serving modes: params
    bitwise equal to the JAX converter's, greedy /inference tokens equal
    to an in-process engine's and batcher's on those params
    (test_torch_convert_tokens_d.py holds those to the JAX package's)."""
    from distributed_llm_inferencing_tpu_torch.ops.sampling import (
        SamplingParams)
    from distributed_llm_inferencing_tpu_torch.runtime.engine import (
        InferenceEngine)
    d = saved(mt)
    name = f"experts-{mt}"
    tcfg, want = jax_params(d, "bfloat16")
    for serving in ("engine", "batched"):
        body = {"model_name": name, "checkpoint_path": d, "max_seq": 64}
        if serving == "batched":
            body.update(serving="batched", kv_blocks=32, kv_block_size=8,
                        slots=2)
        _load(url, body)
        try:
            lm = worker.models[name]
            assert_bitwise((lm.batcher or lm.engine).params, want)
            eos = lm.tokenizer.eos_token_id
            ref = InferenceEngine(tcfg, want, max_seq=64,
                                  device="cpu").generate(
                [[5, 9, 13, 2, 40, 7, 77, 3]], max_new_tokens=8, seed=1,
                sampling=SamplingParams.greedy(),
                eos_token_id=eos).tokens[0]
            assert _greedy(url, name) == ref and ref, serving
        finally:
            _unload(url, name)


@pytest.mark.parametrize("serving", ["engine", "batched"])
def test_deepseek_rows_load_by_name(url, worker, serving):
    """tiny-deepseek by name in either mode (deepseek-proxy is its
    full-size row, driven on the card): the engine on the latent cache,
    the batcher on the materialized pool; /health names the row."""
    body = {"model_name": "tiny-deepseek", "allow_random_init": True,
            "dtype": "float32", "max_seq": 64}
    if serving == "batched":
        body.update(serving="batched", kv_blocks=32, kv_block_size=8,
                    slots=2)
    _load(url, body)
    try:
        lm = worker.models["tiny-deepseek"]
        owner = lm.batcher or lm.engine
        assert owner.cfg.mla_latent_cache == (serving == "engine")
        assert len(_greedy(url, "tiny-deepseek")) == 8
        [m] = [m for m in requests.get(url + "/health", timeout=30).json()[
            "loaded_models"] if m["name"] == "tiny-deepseek"]
        assert m["serving"] == serving
    finally:
        _unload(url, "tiny-deepseek")


def test_float32_load_computes_on_bf16_rounded_weights(url, worker):
    """The JAX worker converts a checkpoint to bf16 (its config default)
    and only then applies the body's "dtype": "float32" (ROADMAP Queue
    C): every float weight served is a bf16 value, though the file holds
    f32 ones; the tokens above equal the JAX worker's under this order."""
    from distributed_llm_inferencing_tpu_torch.models import hf_files
    d = saved("llama")
    _load(url, {"model_name": "quirk", "checkpoint_path": d,
                "dtype": "float32", "max_seq": 64})
    try:
        params = worker.models["quirk"].engine.params
        f = hf_files.SafetensorsFile(os.path.join(d, hf_files.SAFETENSORS))
        stored = f.get("model.layers.0.self_attn.o_proj.weight").clone()
        f.close()
        served = params["layers.0.o.w"]
        assert served.dtype == torch.float32
        assert torch.equal(served, served.bfloat16().float())
        assert torch.equal(served, stored.T.bfloat16().float())
        assert not torch.equal(served, stored.T)
    finally:
        _unload(url, "quirk")


def test_native_checkpoint_from_the_convert_cli(url, worker):
    """``convert --quantize int4`` writes the port's native checkpoint
    (tokenizer files carried along); /load_model with native_checkpoint
    serves the bytes and tokens of the HF directory loaded with
    "quantize": "int4", and encodes text with the carried tokenizer."""
    d = with_tokenizer("llama")
    out = os.path.join(_ROOT, "llama-native-int4")
    subprocess.run([sys.executable, "-m",
                    "distributed_llm_inferencing_tpu_torch", "convert",
                    "--checkpoint_path", d, "--out", out, "--quantize",
                    "int4", "--device", "cpu"], check=True, cwd=ROOT,
                   timeout=300)
    assert {"config.json", "params.safetensors",
            "tokenizer.json"} <= set(os.listdir(out))
    _load(url, {"model_name": "hf-int4", "checkpoint_path": d,
                "quantize": "int4", "dtype": "float32", "max_seq": 64})
    _load(url, {"model_name": "native-int4", "native_checkpoint": out,
                "dtype": "float32", "max_seq": 64})
    try:
        assert_bitwise(worker.models["native-int4"].engine.params,
                       worker.models["hf-int4"].engine.params)
        assert _greedy(url, "native-int4") == _greedy(url, "hf-int4")
        [m] = [m for m in requests.get(url + "/health", timeout=30).json()[
            "loaded_models"] if m["name"] == "native-int4"]
        assert m["source"] == out and m["quantize"] == "int4"
        texts = [requests.post(url + "/inference", json={
            "model_name": n, "prompt": "hello world", "max_new_tokens": 4,
            "sampling": {"do_sample": False}}, timeout=60).json()["result"]
            for n in ("native-int4", "hf-int4")]
        assert texts[0] == texts[1]
    finally:
        _unload(url, "native-int4")
        _unload(url, "hf-int4")


def _write_config(name, conf):
    d = os.path.join(_ROOT, name)
    os.makedirs(d, exist_ok=True)
    import json
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(conf, f)
    return d


def _orbax_dir():
    d = os.path.join(_ROOT, "orbax")
    if not os.path.isdir(d):
        cfg = jax_config("tiny-llama")
        jax_save_checkpoint(d, cfg, jax_init_params(cfg,
                                                    jax.random.PRNGKey(0)))
    return d


def _missing_key_dir():
    from distributed_llm_inferencing_tpu_torch.models import hf_files
    import shutil
    src = saved("llama")
    d = os.path.join(_ROOT, "llama-missing-w")
    shutil.copytree(src, d, dirs_exist_ok=True)
    f = hf_files.SafetensorsFile(os.path.join(src, hf_files.SAFETENSORS))
    keep = {k: f.get(k).clone() for k in f.keys()
            if k != "model.layers.0.self_attn.k_proj.weight"}
    f.close()
    hf_files.write_safetensors(os.path.join(d, hf_files.SAFETENSORS), keep)
    return d


@pytest.mark.parametrize("case,cause", [
    ("dbrx", "moe_normalize_expert_weights"),
    ("phi_qk_layernorm", "qk_layernorm"),
    ("missing", "model.layers.0.self_attn.k_proj.weight"),
    ("hub_name", "not a local directory"),
    ("native_hub_name", "not a local directory"),
    ("orbax", "Orbax"), ("no_transformers", "transformers"),
])
def test_checkpoint_refusals_name_the_cause(url, monkeypatch, case, cause):
    field = "checkpoint_path"
    if case == "dbrx":
        # the JAX converter's refusal of a p-norm other than 1
        path = _write_config("dbrx", {"model_type": "dbrx", "ffn_config": {
            "moe_normalize_expert_weights": 2.0}})
    elif case == "phi_qk_layernorm":
        path = _write_config("phi-qk", {"model_type": "phi",
                                        "qk_layernorm": True})
    elif case == "missing":
        path = _missing_key_dir()
    elif case == "hub_name":
        path = "meta-llama/Llama-3.1-8B"
    elif case == "native_hub_name":
        path, field = "meta-llama/Llama-3.1-8B", "native_checkpoint"
    elif case == "orbax":
        path, field = _orbax_dir(), "native_checkpoint"
    else:   # tokenizer files, and no transformers to read them
        path = with_tokenizer("llama")
        monkeypatch.setitem(sys.modules, "transformers", None)
    r = _load(url, {"model_name": f"refused-{case}", field: path,
                    "max_seq": 64}, status=400)
    assert r["status"] == "error" and cause in r["message"], r
    names = [m["name"] for m in
             requests.get(url + "/health", timeout=30).json()["loaded_models"]]
    assert f"refused-{case}" not in names


def test_native_checkpoint_of_a_random_init(url, worker):
    """``convert --model_name --allow_random_init`` stores a registry
    row's seeded weights (the JAX CLI's testing path); they load as
    drawn and serve."""
    from distributed_llm_inferencing_tpu_torch.models.params import (
        init_params)
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    out = os.path.join(_ROOT, "tiny-llama-native")
    subprocess.run([sys.executable, "-m",
                    "distributed_llm_inferencing_tpu_torch", "convert",
                    "--model_name", "tiny-llama", "--allow_random_init",
                    "--dtype", "float32", "--out", out, "--device", "cpu"],
                   check=True, cwd=ROOT, timeout=300)
    _load(url, {"model_name": "rnd", "native_checkpoint": out,
                "max_seq": 64})
    try:
        cfg = get_config("tiny-llama").replace(dtype="float32")
        assert_bitwise(worker.models["rnd"].engine.params, init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        assert len(_greedy(url, "rnd")) == 8
    finally:
        _unload(url, "rnd")
