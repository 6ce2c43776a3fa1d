"""Worker agent of the port: engine-mode and batched serving over JSON HTTP.

Speaks the reference worker's wire protocol for the routes the port has,
so a master can drive either worker:

- ``GET /health``: status, device inventory from torch.cuda (``platform``,
  ``kind``, ``count``), loaded models (with ``serving``, the weight
  quantization, ``param_bytes`` — the bytes the weights take as stored —
  and, for batched models, the scheduler's stats; for engine-mode ones
  the ``mesh``, and under tp the data collectives' ``backend``, with
  ``param_bytes`` one rank's share), metrics.
- ``POST /load_model``: ``model_name``, ``allow_random_init``, ``dtype``,
  ``max_seq``, ``quantize`` (weight-only ``"int8"`` or ``"int4"``,
  ops/quant.py), ``embed_quantize`` (``"int8"``: the per-row int8
  embedding table), ``mesh`` (``{"tp": N}``: tensor parallelism over N
  ranks, engine mode; parallel/mesh.py) — builds an ``InferenceEngine``
  (engine mode, the default),
  or with ``"serving": "batched"`` a ``ContinuousBatcher`` over a paged KV
  pool (``kv_blocks``, ``kv_block_size``, ``slots``, ``prefill_chunk``,
  ``decode_chunk_cap``) whose scheduler thread serves concurrent
  requests.
- ``POST /unload_model``: ``model_name``; under tp it stops the model's
  follower processes.
- ``POST /inference``: ``model_name``, ``prompt`` or ``prompt_tokens``,
  ``max_new_tokens`` (or ``max_length``), ``sampling``, ``seed``; answers
  ``status``, ``result``, ``tokens``, ``execution_time`` and ``cost``
  (engine mode adds its timings; batched mode adds ``ttft_ms`` and
  ``scheduler``).

Fields of the reference protocol that the port does not implement yet —
``speculative``, ``kv_host_mb``, ``kv_source``, ``kv_export``,
``adapter``, ``resume``, ``request_tag``, ``kv_quantize`` (the int8 KV
cache), checkpoint paths — get a 400, never a silent ignore; so does a
``quantize`` or ``embed_quantize`` value outside the modes above, and a
``mesh`` the port cannot serve (an axis other than tp above 1, tp with
``"serving": "batched"``, or a tp the model's shapes do not divide).

Run: ``python -m distributed_llm_inferencing_tpu_torch worker --port 8100``
(``--device cpu`` for the plain-PyTorch path without a GPU).
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Dict

import torch

from distributed_llm_inferencing_tpu_torch.models.params import param_bytes
from distributed_llm_inferencing_tpu_torch.models.registry import get_config
from distributed_llm_inferencing_tpu_torch.ops.quant import MODES
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.parallel.mesh import (
    MeshSpec, validate_spec)
from distributed_llm_inferencing_tpu_torch.runtime import httpd
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from distributed_llm_inferencing_tpu_torch.utils.device import (
    inventory, resolve_device)
from distributed_llm_inferencing_tpu_torch.utils.metrics import Metrics
from distributed_llm_inferencing_tpu_torch.utils.tokenizer import (
    load_tokenizer)

_UNPORTED_LOAD = ("kv_quantize", "checkpoint_path", "native_checkpoint",
                  "speculative", "kv_host_mb")
_UNPORTED_INFER = ("speculative", "adapter", "resume", "kv_source",
                   "kv_export", "request_tag")
_DTYPES = ("bfloat16", "float32")
_SERVING = (None, "engine", "batched")


class LoadedModel:
    """One served model: an engine (engine mode) or a batcher."""

    def __init__(self, engine, tokenizer, source: str, batcher=None):
        self.engine = engine
        self.batcher = batcher
        self.tokenizer = tokenizer
        self.source = source
        self.lock = threading.Lock()   # engine.generate is not reentrant

    @property
    def cfg(self):
        return (self.batcher or self.engine).cfg

    def describe(self, name: str) -> dict:
        owner = self.batcher or self.engine
        out = {"name": name, "source": self.source,
               "serving": "batched" if self.batcher else "engine",
               "max_seq": owner.max_seq, "device": str(owner.device),
               "quantize": owner.cfg.quant,
               "embed_quantize": owner.cfg.embed_quant,
               "param_bytes": param_bytes(owner.params)}
        if self.batcher is not None:
            out["scheduler"] = self.batcher.stats()
        else:
            stats = self.engine.stats()
            out["mesh"] = stats["mesh"]
            if "backend" in stats:
                out["backend"] = stats["backend"]
        return out

    def close(self):
        if self.batcher is not None:
            self.batcher.stop()   # fails whatever is still queued or running
        else:
            self.engine.close()   # stops tp followers


def _unported(body, fields):
    bad = [f for f in fields if body.get(f) not in (None, {}, "")]
    if bad:
        return 400, {"status": "error",
                     "message": f"not supported by this worker yet: {bad}"}
    return None


class WorkerAgent:
    """Holds loaded models and serves the lifecycle + inference API."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.models: Dict[str, LoadedModel] = {}
        self._models_lock = threading.Lock()
        self._loading: set = set()
        self.metrics = Metrics()
        self.started = time.time()
        self.service = httpd.JsonHTTPService("worker")
        s = self.service
        s.add("GET", "/health", self.health)
        s.add("POST", "/load_model", self.load_model)
        s.add("POST", "/unload_model", self.unload_model)
        s.add("POST", "/inference", self.inference)

    def health(self, body):
        with self._models_lock:
            loaded = [m.describe(n) for n, m in self.models.items()]
        inv = inventory(self.device)
        return {
            "status": "online",
            "uptime_s": time.time() - self.started,
            "device": {k: inv[k] for k in ("platform", "kind", "count")},
            "resources": {"devices": inv["devices"],
                          "device": inv["platform"]},
            "loaded_models": loaded,
            "metrics": self.metrics.snapshot(),
        }

    def load_model(self, body):
        name = body.get("model_name")
        if not name:
            return 400, {"status": "error", "message": "model_name required"}
        refused = _unported(body, _UNPORTED_LOAD)
        if refused:
            return refused
        if body.get("serving") not in _SERVING:
            return 400, {"status": "error",
                         "message": "serving must be 'engine' or 'batched'; "
                                    f"got {body.get('serving')!r}"}
        with self._models_lock:
            if name in self.models:
                return 200, {"status": "success",
                             "message": f"model {name} already loaded"}
            if name in self._loading:
                return 409, {"status": "error",
                             "message": f"model {name} load in progress"}
            self._loading.add(name)
        try:
            with self.metrics.time("load_model"):
                return self._load(body, name)
        finally:
            with self._models_lock:
                self._loading.discard(name)

    def _load(self, body, name):
        t0 = time.time()
        try:
            cfg = get_config(name)
        except KeyError as e:
            return 400, {"status": "error", "message": str(e)}
        if not body.get("allow_random_init"):
            return 400, {"status": "error",
                         "message": "no checkpoint loading in this worker "
                                    "yet; pass allow_random_init=true"}
        if body.get("dtype"):
            if body["dtype"] not in _DTYPES:
                return 400, {"status": "error",
                             "message": f"dtype must be one of {_DTYPES}"}
            cfg = cfg.replace(dtype=body["dtype"])
        if body.get("quantize"):
            if body["quantize"] not in MODES:
                return 400, {"status": "error",
                             "message": f"quantize must be one of {MODES}"}
            cfg = cfg.replace(quant=body["quantize"])
        if body.get("embed_quantize"):
            if body["embed_quantize"] != "int8":
                return 400, {"status": "error",
                             "message": "embed_quantize must be 'int8'"}
            cfg = cfg.replace(embed_quant=body["embed_quantize"])
        try:
            mesh = MeshSpec.from_dict(body.get("mesh") or {})
        except (TypeError, ValueError) as e:
            return 400, {"status": "error", "message": f"mesh: {e}"}
        try:
            validate_spec(mesh, cfg)
        except (NotImplementedError, ValueError) as e:
            return 400, {"status": "error", "message": f"mesh: {e}"}
        if mesh.tp > 1 and body.get("serving") == "batched":
            return 400, {"status": "error",
                         "message": "batched serving under tp is a later "
                                    "slice of the port (ROADMAP A12); load "
                                    "with \"serving\": \"engine\""}
        tok = load_tokenizer(body.get("tokenizer_path"), cfg.vocab_size)
        try:
            if body.get("serving") == "batched":
                # continuous batching over the paged KV pool
                # (runtime/batcher.py): requests share decode steps
                # instead of serializing behind the per-model lock
                batcher = ContinuousBatcher(
                    cfg, max_seq=body.get("max_seq"),
                    num_blocks=int(body.get("kv_blocks", 512)),
                    block_size=int(body.get("kv_block_size", 16)),
                    slots=int(body.get("slots", 8)),
                    # chunked prefill cap (blocks); 0/null disables
                    prefill_chunk=(int(body["prefill_chunk"] or 0)
                                   if "prefill_chunk" in body else 32),
                    decode_chunk_cap=body.get("decode_chunk_cap"),
                    device=self.device, metrics=self.metrics)
                batcher.start()
                lm = LoadedModel(None, tok, "random-init", batcher=batcher)
                stats = batcher.stats()
            else:
                engine = InferenceEngine(
                    cfg, mesh_spec=mesh, max_seq=body.get("max_seq"),
                    device=self.device, metrics=self.metrics)
                lm = LoadedModel(engine, tok, "random-init")
                stats = engine.stats()
        except NotImplementedError as e:   # config outside the ported arm
            return 400, {"status": "error", "message": str(e)}
        except (TypeError, ValueError) as e:   # malformed load fields
            return 400, {"status": "error", "message": str(e)}
        with self._models_lock:
            self.models[name] = lm
        self.metrics.inc("models_loaded")
        return 200, {"status": "success", "message": f"model {name} loaded",
                     "load_time_s": time.time() - t0, "stats": stats}

    def unload_model(self, body):
        name = body.get("model_name")
        with self._models_lock:
            m = self.models.pop(name, None)
        if m is None:
            return 404, {"status": "error",
                         "message": f"model {name} not loaded"}
        with m.lock:   # after the request in flight, if any
            m.close()
        del m
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.metrics.inc("models_unloaded")
        return {"status": "success", "message": f"model {name} unloaded"}

    def _prep(self, body):
        name = body.get("model_name")
        m = self.models.get(name)
        if m is None:
            raise KeyError(f"model {name} not loaded")
        if "prompt_tokens" in body:
            prompt = [int(t) for t in body["prompt_tokens"]]
        else:
            prompt = m.tokenizer.encode(body.get("prompt", ""))
        if not prompt:
            raise ValueError("empty prompt")
        vocab = m.cfg.vocab_size
        if not all(0 <= t < vocab for t in prompt):
            # an id past the table would fault the device gather
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        sp_body = body.get("sampling", {})
        sp = SamplingParams(
            temperature=float(sp_body.get("temperature", 0.8)),
            top_k=int(sp_body.get("top_k", 50)),
            top_p=float(sp_body.get("top_p", 0.95)),
            do_sample=bool(sp_body.get("do_sample", True)))
        if "max_new_tokens" in body:
            max_new = int(body["max_new_tokens"])
        else:   # reference parity: max_length counts prompt + new
            max_new = max(1, int(body.get("max_length", 100)) - len(prompt))
        seed = int(body.get("seed", time.time_ns() % (1 << 31)))
        return m, prompt, sp, max_new, seed

    def inference(self, body):
        t0 = time.time()
        refused = _unported(body, _UNPORTED_INFER)
        if refused:
            return refused
        try:
            m, prompt, sp, max_new, seed = self._prep(body)
        except (KeyError, ValueError) as e:
            return 400, {"status": "error", "message": str(e)}
        if m.batcher is not None:
            return self._inference_batched(m, body, prompt, sp, max_new,
                                           seed, t0)
        try:
            with self.metrics.time("inference"), m.lock:
                res = m.engine.generate(
                    [prompt], max_new_tokens=max_new, sampling=sp,
                    seed=seed, eos_token_id=m.tokenizer.eos_token_id)
        except ValueError as e:   # request-shape errors are the caller's
            return 400, {"status": "error", "message": str(e)}
        self.metrics.inc("requests_completed")
        self.metrics.inc("tokens_generated", len(res.tokens[0]))
        self.metrics.gauge("last_decode_tokens_per_s",
                           res.decode_tokens_per_s)
        return {
            "status": "success",
            "result": m.tokenizer.decode(res.tokens[0]),
            "tokens": res.tokens[0],
            "execution_time": time.time() - t0,
            "prefill_ms": res.prefill_ms,
            "decode_ms": res.decode_ms,
            "tokens_per_s": res.decode_tokens_per_s,
            "cost": res.cost(),
        }

    def _inference_batched(self, m, body, prompt, sp, max_new, seed, t0):
        """Enqueue into the model's batcher and wait: no per-model lock,
        the scheduler interleaves this request with the others."""
        req = None
        try:
            with self.metrics.time("inference"):
                req = m.batcher.submit(
                    prompt, max_new_tokens=max_new, sampling=sp,
                    eos_token_id=m.tokenizer.eos_token_id, seed=seed)
                toks = req.wait(timeout=float(body.get("timeout", 300)))
        except TimeoutError as e:
            req.cancel()   # free the slot; generate for nobody
            return 408, {"status": "error", "message": str(e)}
        except (ValueError, RuntimeError) as e:
            return 400, {"status": "error", "message": str(e)}
        self.metrics.inc("requests_completed")
        self.metrics.inc("tokens_generated", len(toks))
        return {
            "status": "success",
            "result": m.tokenizer.decode(toks),
            "tokens": toks,
            "execution_time": time.time() - t0,
            "ttft_ms": req.ttft_ms,
            "cost": req.cost,
            "scheduler": m.batcher.stats(),
        }

    def serve(self, host="0.0.0.0", port=8100, background=False):
        return self.service.serve(host, port, background=background)

    def shutdown(self):
        self.service.shutdown()
        with self._models_lock:
            models = list(self.models.values())
        for m in models:
            m.close()


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="PyTorch/CUDA worker agent")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8100)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch path)")
    args = ap.parse_args(argv)
    WorkerAgent(device=args.device).serve(args.host, args.port)


if __name__ == "__main__":
    main()
