"""The port's worker agent over real sockets, on the CPU path.

Starts the worker on a localhost port with ``device="cpu"`` and drives
the routes the JAX worker also serves: /health, /load_model,
/inference, /unload_model — including the 400s for request fields this
slice does not implement.
"""

import pytest
import requests

from distributed_llm_inferencing_tpu_torch.runtime.worker import WorkerAgent


@pytest.fixture(scope="module")
def url():
    w = WorkerAgent(device="cpu")
    w.serve("127.0.0.1", 0, background=True)
    yield f"http://127.0.0.1:{w.service.port}"
    w.shutdown()


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
    {"serving": "batched", "speculative": "ngram"}, {"quantize": "int3"},
    {"embed_quantize": "int4"}, {"kv_quantize": "int8"},
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


@pytest.mark.parametrize("extra", [{"speculative": "ngram"},
                                   {"adapter": "a1"}])
def test_unported_inference_fields_are_refused(url, extra):
    r = requests.post(url + "/inference", json={
        "model_name": "tiny-llama", "prompt_tokens": [1, 2],
        "max_new_tokens": 2, **extra}, timeout=30)
    assert r.status_code == 400


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
