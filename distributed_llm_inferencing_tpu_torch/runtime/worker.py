"""Worker agent of the port: engine-mode and batched serving over JSON HTTP.

Speaks the reference worker's wire protocol for the routes the port has,
so the reference master can drive either worker:

- ``GET /health``: status (``"draining"`` during a drain, else
  ``"online"``), ``role`` (``WORKER_ROLES``: the ``role`` argument, else
  ``DLI_WORKER_ROLE``, else ``"mixed"``; ``POST /role`` changes it),
  ``arena_occupancy`` (the fullest batched model's host KV arena, the
  fraction of its budget stored; null without an arena), device
  inventory from torch.cuda (``platform``, ``kind``, ``count``), loaded
  models (with ``serving``, the weight quantization, ``param_bytes`` —
  the bytes the weights take as stored — and, for batched models, the
  scheduler's stats; for engine-mode ones the ``mesh``'s axis sizes, and
  in a group (tp, pp or sp) the data collectives' ``backend``, with
  ``param_bytes`` one rank's share;
  for both the decode programs kept, how many are captured CUDA graphs
  and the bytes their pool holds, runtime/graphs.py; a batched model's
  scheduler stats carry its ``mesh`` and, in a group, ``backend`` too),
  metrics.
- ``GET /metrics``: the metrics registry as Prometheus text exposition.
- ``POST /load_model``: ``model_name``; the weights from
  ``native_checkpoint`` (the port's own format, models/checkpoint.py),
  else ``checkpoint_path`` (an HF checkpoint directory of one of the 20
  converter types of models/convert.py), else, with
  ``allow_random_init``, random weights for a row of models/registry.py
  (the llama, gpt2, opt, qwen2, gemma, pythia, phi, falcon, bloom, mpt
  and gpt-j families, and the experts of mixtral-8x7b, moe-proxy-8e
  and tiny-mixtral); ``tokenizer_path`` (default: the checkpoint
  directory when it holds tokenizer files), ``dtype``,
  ``max_seq``, ``quantize`` (weight-only ``"int8"`` or ``"int4"``,
  ops/quant.py), ``embed_quantize`` (``"int8"``: the per-row int8
  embedding table), ``mesh`` (``{"tp": N}``, ``{"pp": N}`` in either
  mode, ``{"sp": N}`` in engine mode, and their compositions: a grid
  of pp·sp·tp ranks; parallel/mesh.py) — builds an
  ``InferenceEngine`` (engine mode, the default),
  or with ``"serving": "batched"`` a ``ContinuousBatcher`` over a paged KV
  pool (``kv_blocks``, ``kv_block_size``, ``slots``, ``prefill_chunk``,
  ``decode_chunk_cap``, the host KV tier's ``kv_host_mb``, 0 to
  disable it, and ``kv_digest_chunk``, runtime/kvtier.py; and on-device
  speculative decoding, ``speculative`` "ngram" with ``spec_gamma``) whose
  scheduler thread serves concurrent requests; a batched load captures
  its decode program before it answers (``warm_decode_programs``), so
  the first request pays no capture. ``kv_quantize`` (``"int8"``) makes
  either mode's KV cache int8 (ops/kvcache.py).
- ``POST /load_adapter``: ``model_name``, ``adapter`` and ``source`` (a
  ``lora_config.json`` + ``lora.npz`` directory or a ``synth:`` URI,
  models/lora.py) make a LoRA adapter resident for that model (idempotent;
  400 for a missing field or an adapter the model refuses, 404 for a
  model not loaded); ``POST /unload_adapter``: ``model_name`` and
  ``adapter`` (409 while requests reference it, 404 when not resident).
  An /inference body's ``adapter`` then runs the request through it, in
  either mode (a resume record's adapter wins); an adapter not resident
  is a 400, and no request is ever served on base weights in its place.
  ``/health`` advertises the resident adapters (engine mode:
  ``loaded_models[i].adapters``, batched: ``.scheduler.adapters``),
  which the master's adapter affinity reads.
- ``POST /unload_model``: ``model_name``; releases the model's decode
  programs (their graphs and graph pool) with its weights, and under tp
  stops its follower processes.
- ``POST /inference``: ``model_name``, ``prompt`` or ``prompt_tokens``,
  ``max_new_tokens`` (or ``max_length``), ``sampling``, ``seed``,
  ``timeout``, ``request_tag``, and for a batched model the
  disaggregation fields the master sends: ``kv_export`` (park the
  prompt's KV in the host arena at finish, for a peer's ``/kv_fetch``)
  and ``kv_source`` (``{"url", "model"}``: pull the prompt's prefix KV
  from that peer into the arena on the handler thread before
  submitting; a failed pull costs a recompute) and ``resume`` (a
  migrated request's record: its prompt ids, seed, emitted tokens and
  speculation state; its prefix KV, emitted tokens included, is what
  ``kv_source`` prefetches); in engine mode ``speculative`` ("ngram", one
  sequence) and ``spec_gamma`` (1 to 16); answers
  ``status``, ``result``,
  ``tokens``, ``execution_time`` and ``cost`` (engine mode adds its
  timings; batched mode adds ``ttft_ms`` and ``scheduler``). A
  ``request_tag`` makes the dispatch idempotent: a repeat replays the
  cached result (``idempotent: true``, the last ``IDEM_CACHE`` results),
  a repeat that arrives while the first runs joins it, and a join that
  outlives its ``timeout`` gets a 408 with ``in_flight: true``.
- ``POST /inference_batch``: ``model_name`` and ``requests`` (at most
  ``BATCH_RPC_MAX`` /inference bodies); answers one JSON line
  ``{request_tag, status, body}`` per sub-request as each completes. A
  batched model admits the fresh sub-requests in wire order
  (``ContinuousBatcher.enqueue``); a sub-request that fails prep or
  validation answers its own error (400, or 500 for a field of the wrong
  type) and its siblings run on.
- ``POST /inference_stream``: an /inference body; server-sent events
  ``token`` (``step``, ``token``, ``text``), then ``done`` (``result``,
  and ``tokens_per_s`` in engine mode or ``ttft_ms`` batched) or
  ``error``. A bad body is a plain 400.
- ``POST /cancel``: ``request_tag`` of an in-flight batched request; its
  slot and blocks free at the scheduler's next step and its /inference
  answers an error. 400 without a tag, 404 for a tag not in flight
  (engine-mode requests are not cancellable mid-generate).
- ``POST /drain``: new inference gets 503 (``draining: true``,
  ``Retry-After: 5``) while in-flight requests finish; answers
  ``drained`` once idle, or after ``timeout`` seconds with what is still
  ``in_flight``. ``POST /undrain`` re-opens.
- ``POST /role``: ``role``, one of ``WORKER_ROLES``; the master's
  elastic rebalancer moves nodes between the prefill and decode pools
  with it (the worker serves whatever it is sent either way).
- ``POST /kv_fetch``: ``model_name`` and ``digests`` (at most
  ``kvwire.MAX_DIGESTS`` block digests); streams the matching host-arena
  blocks as runtime/kvwire.py frames, then the terminal frame with the
  digests the arena lacked; past ``DLI_KV_FETCH_MAX_MB`` the stream is
  cut and the terminal frame counts what was not sent.
- ``POST /migrate_out``: ``request_tag`` (and ``model_name``) of an
  in-flight batched request: its KV is exported into the host arena and
  its slot freed at the scheduler's next step, and its own dispatch
  (/inference, or its /inference_batch line) answers 303 ``{"status":
  "migrated", "resume": ...}`` for the master to re-dispatch elsewhere
  with the resume record and this worker as ``kv_source``. 400 without
  a tag, 404 for a tag not in flight, 409 when the request completed
  first (its result stands) or serves in engine mode; lease-fenced;
  ``requests_migrated_out`` counts the handoffs.

Every route needs ``Authorization: Bearer <key>`` when the worker has an
auth key (the ``auth_key`` argument, else ``DLI_AUTH_KEY`` when
``DLI_AUTH_ENABLED``): 401 without it, /health and /metrics included.
A call carrying ``X-DLI-Master-Term`` (and ``X-DLI-Master-Nonce``) from a
master term older than the newest this worker has seen gets a 409
(``stale_term: true``, header ``X-DLI-Stale-Term``) on the routes that
dispatch or change state; a call without the headers is never fenced.

Fields of the reference protocol that the port does not implement yet get
a 400, never a silent ignore, each with the ROADMAP Queue A item that
brings it: a ``speculative`` mode other than "ngram", a ``spec_gamma``
outside [1, 16] (per request) or not an integer, ``speculative`` on a
batched model's request (the batched load's own ``speculative`` serves
it), a ``quantize``,
``embed_quantize`` or ``kv_quantize`` value outside the modes above, a
``kv_host_mb`` or ``kv_digest_chunk`` that is not a number, a
checkpoint the port cannot serve (a path that is not a local directory,
a converter type or config switch outside the ported families, a tensor
the files lack, a JAX Orbax directory, tokenizer files on a node without
``transformers``), and a
``mesh`` the port cannot serve (dp, item 9.16, or ep, item 9.8, above
1; tp with the experts, latent attention, ``qkv_clip`` or sinks, item
9.8; or a tp the model's shapes do not divide), and a model whose config
switches on a feature outside the ported families
(models/transformer.py ``check_supported``). Refused as the JAX worker
refuses them: batched serving with sp (the scheduler owns the batch
dimension), pp that does not divide the layers or over a mixed
dense/MoE stack, sp with sinks or with tp above the kv heads, and
``/load_adapter`` under pp. A batched model under tp or pp refuses what
its followers cannot replay: a load's ``kv_host_mb`` above 0 (the host
KV tier, item 9.12; such a load has no tier unless asked), an
/inference ``kv_source`` or ``kv_export`` and ``/kv_fetch`` (item 9.13),
``resume`` and ``/migrate_out`` (item 9.14), and ``/load_adapter``
under tp in either mode (item 9.11); its overlapped decode pairs are off
(item 9.15).

Run: ``python -m distributed_llm_inferencing_tpu_torch worker --port 8100``
(``--device cpu`` for the plain-PyTorch path without a GPU).
"""

from __future__ import annotations

import collections
import concurrent.futures
import gc
import os
import queue
import threading
import time
from typing import Dict, Optional


from distributed_llm_inferencing_tpu_torch.models.checkpoint import (
    CheckpointSource)
from distributed_llm_inferencing_tpu_torch.models.params import param_bytes
from distributed_llm_inferencing_tpu_torch.models.registry import get_config
from distributed_llm_inferencing_tpu_torch.models.transformer import (
    check_supported)
from distributed_llm_inferencing_tpu_torch.ops.quant import MODES
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.parallel.mesh import (
    MeshSpec, validate_spec)
from distributed_llm_inferencing_tpu_torch.runtime import (
    graphs, httpd, kvwire)
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from distributed_llm_inferencing_tpu_torch.utils.device import (
    inventory, resolve_device)
from distributed_llm_inferencing_tpu_torch.utils.metrics import (
    KV_SERVE_COUNTERS, Metrics)
from distributed_llm_inferencing_tpu_torch.utils.tokenizer import (
    has_tokenizer, load_tokenizer)

# Completed results kept for idempotent replay: a master retries with the
# same request_tag after a timeout, and the cached result makes
# at-least-once delivery execute once.
IDEM_CACHE = int(os.environ.get("DLI_IDEM_CACHE", 256))
# Sub-requests per /inference_batch call (each costs a thread).
BATCH_RPC_MAX = int(os.environ.get("DLI_BATCH_RPC_MAX", 256))

# Lease fencing: the headers a replicated master stamps on every call.
MASTER_TERM_HEADER = "X-DLI-Master-Term"
MASTER_NONCE_HEADER = "X-DLI-Master-Nonce"
STALE_TERM_HEADER = "X-DLI-Stale-Term"

# Disaggregated serving role: "prefill" nodes take long prompts' prefill
# passes, "decode" nodes the decode (pulling prefix KV from prefill peers
# over /kv_fetch), "mixed" both; POST /role changes it at run time.
WORKER_ROLES = ("prefill", "decode", "mixed")
ROLE_CODE = {"mixed": 0.0, "prefill": 1.0, "decode": 2.0}
# Byte budget of one /kv_fetch answer: past it the stream is cut, and
# the fetching peer recomputes the rest.
KV_FETCH_MAX_MB = float(os.environ.get("DLI_KV_FETCH_MAX_MB", 256))

_UNPORTED_LOAD = ()
_UNPORTED_INFER = ()
# How long a /migrate_out snapshot may wait on the scheduler before the
# route gives up (the request then keeps running here).
MIGRATE_TIMEOUT_S = 10.0
_KV_MODES = ("int8",)
# /inference fields a batched model under tp refuses, with the ROADMAP
# Queue A item that brings each (the followers cannot replay them yet)
TP_LATER_FIELDS = {"kv_source": "9.13", "kv_export": "9.13",
                   "resume": "9.14"}
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
            out["adapters"] = self.engine.adapter_stats()
            if "backend" in stats:
                out["backend"] = stats["backend"]
            for k in ("decode_programs", "decode_graphs_captured",
                      "decode_graph_pool_bytes"):
                out[k] = stats[k]
        return out

    def close(self):
        if self.batcher is not None:
            self.batcher.stop()   # fails whatever is still queued or running
        else:
            self.engine.close()   # stops tp followers


def _unported(body, fields):
    """The message refusing the ``fields`` that ``body`` sets, or None."""
    bad = [f for f in fields if body.get(f) not in (None, {}, "")]
    return f"not supported by this worker yet: {bad}" if bad else None


def _status(res):
    """(status, payload) of a handler's result."""
    return (res[0], res[1]) if isinstance(res, tuple) else (200, res)


class WorkerAgent:
    """Holds loaded models and serves the lifecycle + inference API."""

    def __init__(self, device=None, auth_key: Optional[str] = None,
                 role: Optional[str] = None):
        self.device = resolve_device(device)
        role = (role or os.environ.get("DLI_WORKER_ROLE") or "mixed").lower()
        if role not in WORKER_ROLES:
            raise ValueError(f"worker role must be one of {WORKER_ROLES}, "
                             f"got {role!r}")
        self.role = role
        if auth_key is None and os.environ.get(
                "DLI_AUTH_ENABLED", "").lower() in ("1", "true"):
            auth_key = os.environ.get("DLI_AUTH_KEY")
        self.models: Dict[str, LoadedModel] = {}
        self._models_lock = threading.Lock()
        self._loading: set = set()
        self.metrics = Metrics()
        self.started = time.time()
        # request_tag -> in-flight batched request, for /cancel
        self._tagged: Dict[str, object] = {}
        self._tagged_lock = threading.Lock()
        # idempotent dispatch: completed results by request_tag (an LRU)
        # and the executions in flight, which a duplicate joins
        self._idem: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._idem_lock = threading.Lock()
        self._inflight_tags: Dict[str, threading.Event] = {}
        # drain: in-flight inference finishes, new inference gets 503
        self._draining = False
        self._active = 0
        self._active_cv = threading.Condition()
        # the newest (master term, holder nonce) seen on a fenced call
        self._master_term: tuple = (0, None)
        self._master_term_lock = threading.Lock()
        # the peer-fetch client every batched model shares (pooled
        # connections per prefill peer), made at the first batched load
        self._peer_client = None
        self._peer_client_lock = threading.Lock()
        for name in ("requests_completed", "tokens_generated",
                     "idempotent_hits", "idempotent_joins",
                     "requests_cancelled", "requests_migrated_out",
                     "batch_rpcs",
                     "batch_sub_requests", "stale_term_rejections",
                     # the serving side of /kv_fetch; raw: the bytes the
                     # served blocks restore to, sent: the stored
                     # (possibly int8) bytes that crossed the wire
                     *KV_SERVE_COUNTERS):
            self.metrics.inc(name, 0)
        self.metrics.gauge("draining", 0)
        self.metrics.gauge("worker_role", ROLE_CODE[self.role])
        self.service = httpd.JsonHTTPService("worker", auth_key)
        s = self.service
        s.add("GET", "/health", self.health)
        s.add("GET", "/metrics", self.prometheus)
        s.add("POST", "/load_model", self.load_model)
        s.add("POST", "/unload_model", self.unload_model)
        s.add("POST", "/load_adapter", self.load_adapter)
        s.add("POST", "/unload_adapter", self.unload_adapter)
        s.add("POST", "/inference", self.inference)
        s.add("POST", "/inference_batch", self.inference_batch)
        s.add("POST", "/inference_stream", self.inference_stream)
        s.add("POST", "/cancel", self.cancel)
        s.add("POST", "/drain", self.drain)
        s.add("POST", "/undrain", self.undrain)
        s.add("POST", "/role", self.set_role)
        s.add("POST", "/kv_fetch", self.kv_fetch)
        s.add("POST", "/migrate_out", self.migrate_out)

    # ---- lease fencing -------------------------------------------------

    def note_master_term(self, nonce: str, term: int) -> bool:
        """True when (term, nonce) is current, advancing the high-water
        mark if newer; False when stale: an older term, or another holder
        at the same term (whoever presented a term first holds it)."""
        with self._master_term_lock:
            cur_term, cur_nonce = self._master_term
            if term > cur_term:
                self._master_term = (int(term), str(nonce))
                return True
            if term == cur_term and cur_nonce in (None, nonce):
                self._master_term = (int(term), str(nonce))
                return True
        self.metrics.inc("stale_term_rejections")
        return False

    def master_term(self) -> int:
        with self._master_term_lock:
            return self._master_term[0]

    def _term_guard(self, _request):
        """None when the caller may proceed, else the 409 for a call from
        a stale master term."""
        if _request is None:
            return None
        raw = _request.headers.get(MASTER_TERM_HEADER)
        if not raw:
            return None       # an unfenced caller
        try:
            term = int(raw)
        except (TypeError, ValueError):
            return None
        nonce = _request.headers.get(MASTER_NONCE_HEADER) or ""
        if self.note_master_term(nonce, term):
            return None
        cur = self.master_term()
        return 409, {"status": "error", "stale_term": True,
                     "message": f"master term {term} is stale "
                                f"(current lease term: {cur})"}, \
            {STALE_TERM_HEADER: str(cur)}

    # ---- status ----------------------------------------------------------

    def health(self, body):
        with self._models_lock:
            loaded = [m.describe(n) for n, m in self.models.items()]
        inv = inventory(self.device)
        # the fullest arena: the master keeps prefill off a node whose
        # arena would evict what a decode peer is about to fetch
        occ = [lm["scheduler"]["kvtier"]["occupancy"] for lm in loaded
               if (lm.get("scheduler") or {}).get("kvtier")]
        return {
            "status": "draining" if self._draining else "online",
            "uptime_s": time.time() - self.started,
            "role": self.role,
            "arena_occupancy": max(occ) if occ else None,
            "device": {k: inv[k] for k in ("platform", "kind", "count")},
            "resources": {"devices": inv["devices"],
                          "device": inv["platform"]},
            "loaded_models": loaded,
            "metrics": self.metrics.snapshot(),
        }

    def prometheus(self, body):
        return (self.metrics.prometheus().encode(),
                "text/plain; version=0.0.4")

    # ---- model lifecycle -------------------------------------------------

    def load_model(self, body, _request=None):
        stale = self._term_guard(_request)
        if stale:
            return stale
        if self._draining:
            return self._refuse_draining()
        name = body.get("model_name")
        if not name:
            return 400, {"status": "error", "message": "model_name required"}
        refused = _unported(body, _UNPORTED_LOAD)
        if refused:
            return 400, {"status": "error", "message": refused}
        if body.get("speculative") not in (None, "ngram"):
            return 400, {"status": "error",
                         "message": "unknown speculative mode "
                                    f"{body['speculative']!r} (supported: "
                                    "'ngram')"}
        try:
            int(body.get("spec_gamma", 4))
        except (TypeError, ValueError):
            return 400, {"status": "error",
                         "message": "spec_gamma must be an integer"}
        if body.get("kv_quantize") and body["kv_quantize"] not in _KV_MODES:
            return 400, {"status": "error",
                         "message": f"kv_quantize must be one of {_KV_MODES}"}
        for f in ("kv_host_mb", "kv_digest_chunk"):
            try:
                if body.get(f) is not None:
                    float(body[f])
            except (TypeError, ValueError):
                return 400, {"status": "error",
                             "message": f"{f} must be a number"}
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
        if body.get("dtype") and body["dtype"] not in _DTYPES:
            return 400, {"status": "error",
                         "message": f"dtype must be one of {_DTYPES}"}
        if body.get("quantize") and body["quantize"] not in MODES:
            return 400, {"status": "error",
                         "message": f"quantize must be one of {MODES}"}
        if body.get("embed_quantize") and body["embed_quantize"] != "int8":
            return 400, {"status": "error",
                         "message": "embed_quantize must be 'int8'"}
        native, ckpt = body.get("native_checkpoint"), body.get("checkpoint_path")
        source = None
        try:
            if native or ckpt:
                # the configuration alone first: a refused type or switch
                # is refused before any weight is read
                source = CheckpointSource(
                    "native" if native else "hf", native or ckpt,
                    dtype=body.get("dtype") or None,
                    quantize=body.get("quantize") or None,
                    embed_quantize=body.get("embed_quantize") or None)
                cfg = source.config().replace(name=name)
            else:
                cfg = get_config(name)
                if not body.get("allow_random_init"):
                    return 400, {"status": "error",
                                 "message": "no checkpoint_path given; pass "
                                            "allow_random_init=true for a "
                                            "demo model"}
                cfg = cfg.replace(dtype=body.get("dtype") or cfg.dtype,
                                  quant=body.get("quantize") or None,
                                  embed_quant=body.get("embed_quantize")
                                  or None)
            if body.get("kv_quantize"):
                cfg = cfg.replace(kv_quant=body["kv_quantize"])
            check_supported(cfg)
        except KeyError as e:
            return 400, {"status": "error", "message": str(e)}
        except (NotImplementedError, ValueError, OSError) as e:
            return 400, {"status": "error", "message": str(e)}
        try:
            mesh = MeshSpec.from_dict(body.get("mesh") or {})
        except (TypeError, ValueError) as e:
            return 400, {"status": "error", "message": f"mesh: {e}"}
        if body.get("serving") == "batched" and (mesh.sp > 1 or mesh.dp > 1):
            # the JAX worker's refusal, before any weight is read
            return 400, {"status": "error",
                         "message": "batched serving supports tp/pp mesh "
                                    "axes; drop dp/sp or use default mode"}
        try:
            validate_spec(mesh, cfg)
        except (NotImplementedError, ValueError) as e:
            return 400, {"status": "error", "message": f"mesh: {e}"}
        # the tokenizer: tokenizer_path, else the checkpoint directory's
        tok_dir = body.get("tokenizer_path") or next(
            (d for d in (ckpt, native) if has_tokenizer(d)), None)
        try:
            tok = load_tokenizer(tok_dir, cfg.vocab_size)
        except (ValueError, OSError) as e:
            return 400, {"status": "error", "message": str(e)}
        params = loader = None
        try:
            if source is not None and mesh.world > 1:
                loader = source.load   # every rank reads its own cut
            elif source is not None:
                params = source.load(self.device)
            # a batched tp or pp load has no host tier unless it asks
            # (then a 400: ROADMAP Queue A item 9.12)
            kv_host_mb = (float(body["kv_host_mb"])
                          if body.get("kv_host_mb") is not None
                          else 0.0 if mesh.world > 1 else None)
            if body.get("serving") == "batched":
                # continuous batching over the paged KV pool
                # (runtime/batcher.py): requests share decode steps
                # instead of serializing behind the per-model lock
                batcher = ContinuousBatcher(
                    cfg, params, max_seq=body.get("max_seq"),
                    num_blocks=int(body.get("kv_blocks", 512)),
                    block_size=int(body.get("kv_block_size", 16)),
                    slots=int(body.get("slots", 8)),
                    # chunked prefill cap (blocks); 0/null disables
                    prefill_chunk=(int(body["prefill_chunk"] or 0)
                                   if "prefill_chunk" in body else 32),
                    decode_chunk_cap=body.get("decode_chunk_cap"),
                    device=self.device, metrics=self.metrics,
                    # the host KV tier: None defers to DLI_KV_HOST_MB
                    kv_host_mb=kv_host_mb,
                    kv_digest_chunk=(int(body["kv_digest_chunk"])
                                     if body.get("kv_digest_chunk")
                                     else None),
                    kv_fetcher=self.peer_client(),
                    # on-device prompt-lookup speculative decoding
                    speculative=body.get("speculative"),
                    spec_gamma=int(body.get("spec_gamma", 4)),
                    mesh_spec=mesh, loader=loader)
                batcher.warm_decode_programs()
                batcher.start()
                lm = LoadedModel(None, tok, native or ckpt or "random-init",
                                 batcher=batcher)
                stats = batcher.stats()
            else:
                engine = InferenceEngine(
                    cfg, params, mesh_spec=mesh, max_seq=body.get("max_seq"),
                    device=self.device, metrics=self.metrics, loader=loader)
                lm = LoadedModel(engine, tok, native or ckpt or "random-init")
                stats = engine.stats()
        except NotImplementedError as e:   # config outside the ported arm
            return 400, {"status": "error", "message": str(e)}
        except (TypeError, ValueError, OSError) as e:   # malformed load
            return 400, {"status": "error", "message": str(e)}  # fields/files
        with self._models_lock:
            self.models[name] = lm
        self.metrics.inc("models_loaded")
        return 200, {"status": "success", "message": f"model {name} loaded",
                     "load_time_s": time.time() - t0, "stats": stats}

    def unload_model(self, body, _request=None):
        stale = self._term_guard(_request)
        if stale:
            return stale
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
        graphs.empty_cache(self.device)
        self.metrics.inc("models_unloaded")
        return {"status": "success", "message": f"model {name} unloaded"}

    # ---- LoRA adapters ---------------------------------------------------

    def load_adapter(self, body, _request=None):
        """Make a LoRA adapter resident for a loaded model (the JAX
        worker's route: lease-fenced, refused while draining; the master's
        lazy dispatch-time load lands here). Idempotent for a resident
        name. 400 for missing fields or any refusal (a bad source, a
        shape or rank mismatch, a store full of pinned adapters, a MoE
        base, tp), 404 for a model not loaded."""
        stale = self._term_guard(_request)
        if stale:
            return stale
        if self._draining:
            return self._refuse_draining()
        model = body.get("model_name")
        adapter = body.get("adapter")
        source = body.get("source")
        if not (model and adapter and source):
            return 400, {"status": "error",
                         "message": "model_name, adapter and source "
                                    "required"}
        m = self.models.get(model)
        if m is None:
            return 404, {"status": "error",
                         "message": f"model {model} not loaded"}
        with self.metrics.time("load_adapter"):
            try:
                if m.batcher is not None:
                    info = m.batcher.load_adapter(adapter, source)
                else:
                    with m.lock:   # not beside a generate using its pack
                        ad = m.engine.load_adapter(name=adapter,
                                                   source=source)
                    info = {"name": ad.name, "rank": ad.rank,
                            "nbytes": ad.nbytes, "evicted": []}
            except ValueError as e:
                return 400, {"status": "error", "adapter": adapter,
                             "message": str(e)}
        return {"status": "success", **info}

    def unload_adapter(self, body, _request=None):
        """Drop a resident adapter (lease-fenced): 409 while requests
        still reference it, 404 for a model not loaded or an adapter not
        resident."""
        stale = self._term_guard(_request)
        if stale:
            return stale
        model = body.get("model_name")
        adapter = body.get("adapter")
        m = self.models.get(model)
        if m is None:
            return 404, {"status": "error",
                         "message": f"model {model} not loaded"}
        try:
            if m.batcher is not None:
                dropped = m.batcher.unload_adapter(adapter)
            else:
                with m.lock:
                    dropped = m.engine.unload_adapter(adapter)
        except ValueError as e:
            return 409, {"status": "error", "message": str(e)}
        if not dropped:
            return 404, {"status": "error",
                         "message": f"adapter {adapter} not resident"}
        return {"status": "success", "adapter": adapter}

    # ---- drain ---------------------------------------------------------

    def _refuse_draining(self):
        return 503, {"status": "error", "draining": True,
                     "message": "worker is draining; retry another node"}, \
            {"Retry-After": "5"}

    def _try_begin_inference(self) -> bool:
        """Count one inference in, or refuse it during a drain; the check
        and the count share the lock, so a drain never reports idle with
        a request about to start."""
        with self._active_cv:
            if self._draining:
                return False
            self._active += 1
        return True

    def _end_inference(self):
        with self._active_cv:
            self._active -= 1
            self._active_cv.notify_all()

    def _busy_count(self) -> int:
        """Requests still owed an answer: the handlers' count, or the
        batchers' in-flight requests (which a handler that gave up no
        longer counts), whichever is larger."""
        with self._active_cv:
            n = self._active
        with self._models_lock:
            models = list(self.models.values())
        return max(n, sum(m.batcher.inflight() for m in models
                          if m.batcher is not None))

    def _wait_idle(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._busy_count() == 0:
                return True
            time.sleep(0.05)
        return self._busy_count() == 0

    def drain(self, body, _request=None):
        stale = self._term_guard(_request)
        if stale:
            return stale
        with self._active_cv:
            self._draining = True
        self.metrics.gauge("draining", 1)
        idle = self._wait_idle(float(body.get("timeout", 30)))
        return {"status": "success", "drained": idle,
                "in_flight": self._busy_count()}

    def undrain(self, body, _request=None):
        stale = self._term_guard(_request)
        if stale:
            return stale
        with self._active_cv:
            self._draining = False
        self.metrics.gauge("draining", 0)
        return {"status": "success"}

    # ---- inference -------------------------------------------------------

    def _prep(self, body):
        """(model, prompt, sampling, max_new, seed, extra) of an
        /inference body; ValueError (or KeyError for a model not loaded)
        for a bad one. ``extra``: the ``adapter``, and the engine's
        ``speculative`` and ``spec_gamma``, or the batcher's ``resume``
        record. A resume record's prompt ids, seed and adapter win over
        the body's (the stream continues exactly only on the source's)."""
        refused = _unported(body, _UNPORTED_INFER)
        if refused:
            raise ValueError(refused)
        name = body.get("model_name")
        m = self.models.get(name)
        if m is None:
            raise KeyError(f"model {name} not loaded")
        resume = body.get("resume")
        resume = resume if isinstance(resume, dict) else None
        if (resume and resume.get("prompt_tokens")
                and "prompt_tokens" not in body):
            prompt = [int(t) for t in resume["prompt_tokens"]]
        elif "prompt_tokens" in body:
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
        spec = body.get("speculative")
        try:
            gamma = int(body.get("spec_gamma", 4))
        except (TypeError, ValueError):
            raise ValueError("spec_gamma must be an integer")
        if spec is not None:
            if spec != "ngram":
                raise ValueError(f"unknown speculative mode {spec!r} "
                                 "(supported: 'ngram')")
            if not 1 <= gamma <= 16:
                raise ValueError("spec_gamma must be in [1, 16]")
            if m.batcher is not None:
                raise ValueError(
                    "speculative decoding is engine-mode only; this model "
                    "serves via the continuous batcher")
        if m.batcher is not None and m.batcher.group is not None:
            for f, item in TP_LATER_FIELDS.items():
                if body.get(f):
                    raise ValueError(
                        f"{f} on a batched model under tp or pp is a later "
                        f"slice of the port (ROADMAP Queue A item {item})")
        if resume is not None and resume.get("seed") is not None:
            seed = int(resume["seed"])
        else:
            seed = int(body.get("seed", time.time_ns() % (1 << 31)))
        if resume is not None and resume.get("adapter"):
            adapter = str(resume["adapter"])
        else:
            adapter = body.get("adapter") or None
        extra = ({"resume": resume} if m.batcher is not None
                 else {"speculative": spec, "spec_gamma": gamma})
        extra["adapter"] = adapter
        return m, prompt, sp, max_new, seed, extra

    def inference(self, body, _request=None):
        stale = self._term_guard(_request)
        if stale:
            return stale
        if not self._try_begin_inference():
            return self._refuse_draining()
        try:
            return self._inference_idempotent(body)
        finally:
            self._end_inference()

    def _idem_claim(self, tag: str):
        """One atomic look at ``tag``: ("cached", result) to replay,
        ("join", event) of the execution in flight, or ("own", event):
        the caller runs it and must ``_idem_release``."""
        with self._idem_lock:
            cached = self._idem.get(tag)
            if cached is not None:
                self._idem.move_to_end(tag)
                return "cached", cached
            ev = self._inflight_tags.get(tag)
            if ev is not None:
                return "join", ev
            ev = self._inflight_tags[tag] = threading.Event()
            return "own", ev

    def _idem_release(self, tag: str, my_ev: threading.Event, res):
        """End an owned execution: cache a success for replays, drop the
        in-flight entry and wake the joiners (they look again)."""
        with self._idem_lock:
            if isinstance(res, dict):
                self._idem[tag] = res
                self._idem.move_to_end(tag)
                while len(self._idem) > IDEM_CACHE:
                    self._idem.popitem(last=False)
            self._inflight_tags.pop(tag, None)
            my_ev.set()

    def _inference_idempotent(self, body):
        """Run an /inference body at most once per ``request_tag``: a
        repeat replays the cached result or joins the running execution;
        if that execution failed, the joiner runs it again."""
        tag = str(body["request_tag"]) if body.get("request_tag") else None
        if tag is None:
            return self._inference_execute(body)
        deadline = time.monotonic() + float(body.get("timeout", 300))
        while True:
            kind, obj = self._idem_claim(tag)
            if kind == "cached":
                self.metrics.inc("idempotent_hits")
                return dict(obj, idempotent=True)
            if kind == "own":
                break
            self.metrics.inc("idempotent_joins")
            if not obj.wait(timeout=max(0.0, deadline - time.monotonic())):
                # in_flight: the generation still runs here; retry this
                # node rather than generate again elsewhere
                return 408, {"status": "error", "in_flight": True,
                             "message": f"execution for tag {tag!r} still "
                                        "running past the request budget"}
        res = None
        try:
            res = self._inference_execute(body)
            return res
        finally:
            self._idem_release(tag, obj, res if isinstance(res, dict)
                               else None)

    def _inference_execute(self, body):
        t0 = time.time()
        try:
            m, prompt, sp, max_new, seed, extra = self._prep(body)
        except (KeyError, ValueError) as e:
            return 400, {"status": "error", "message": str(e)}
        if m.batcher is not None:
            try:
                pre = self._prefetch_kv(
                    m, body, self._resume_seq(prompt, extra["resume"]),
                    extra["adapter"])
                req = m.batcher.submit(
                    prompt, max_new_tokens=max_new, sampling=sp,
                    eos_token_id=m.tokenizer.eos_token_id, seed=seed,
                    kv_export=bool(body.get("kv_export")),
                    kv_transfer_bytes=pre, **extra)
            except ValueError as e:
                return 400, {"status": "error", "message": str(e)}
            self._note_prefix(m, body, prompt)
            return self._wait_batched(m, req, body, t0)
        try:
            with self.metrics.time("inference"), m.lock:
                res = m.engine.generate(
                    [prompt], max_new_tokens=max_new, sampling=sp,
                    seed=seed, eos_token_id=m.tokenizer.eos_token_id,
                    **extra)
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

    def _wait_batched(self, m, req, body, t0):
        """Wait out one submitted batched request (cancellable by its
        ``request_tag`` meanwhile) and answer as /inference does."""
        tag = str(body["request_tag"]) if body.get("request_tag") else None
        if tag is not None:
            with self._tagged_lock:
                self._tagged[tag] = req
        try:
            with self.metrics.time("inference"):
                toks = req.wait(timeout=float(body.get("timeout", 300)))
        except TimeoutError as e:
            req.cancel()   # free the slot; generate for nobody
            return 408, {"status": "error", "message": str(e)}
        except RuntimeError as e:   # cancelled, refused, failed, migrated
            if req._migrated:
                # the live-migration handoff rides the open dispatch: the
                # master re-dispatches the resume record elsewhere
                return 303, {"status": "migrated",
                             "resume": req.resume_record,
                             "request_tag": tag}
            return 400, {"status": "error", "message": str(e)}
        finally:
            if tag is not None:
                with self._tagged_lock:
                    self._tagged.pop(tag, None)
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

    def inference_batch(self, body, _request=None):
        """N /inference bodies in one call; each sub-request keeps its own
        semantics (idempotency, drain refusal, errors) and answers its own
        JSON line as it completes."""
        stale = self._term_guard(_request)
        if stale:
            return stale
        subs = body.get("requests")
        if not isinstance(subs, list) or not subs:
            return 400, {"status": "error",
                         "message": "requests: non-empty list required"}
        if len(subs) > BATCH_RPC_MAX:
            return 400, {"status": "error",
                         "message": f"requests: at most {BATCH_RPC_MAX} "
                                    f"sub-requests per batch RPC"}
        if self._draining:
            return self._refuse_draining()
        model = body.get("model_name")
        with self._models_lock:
            m = self.models.get(model)
        self.metrics.inc("batch_rpcs")
        self.metrics.inc("batch_sub_requests", len(subs))
        out: "queue.Queue" = queue.Queue()

        def emit(tag, status, payload):
            out.put({"request_tag": tag, "status": status, "body": payload})

        def run_generic(sub_body, tag):
            """One sub-request through /inference's path: engine-mode
            models, and joins of a tag in flight."""
            try:
                if not self._try_begin_inference():
                    st, pl = _status(self._refuse_draining())
                else:
                    try:
                        st, pl = _status(self._inference_idempotent(sub_body))
                    finally:
                        self._end_inference()
            except Exception as e:
                st, pl = 500, {"status": "error", "message": str(e)}
            emit(tag, st, pl)

        owned = []   # (sub_body, tag, idempotency event or None)
        for sub in subs:
            sub_body = dict(sub, model_name=model)
            tag = (str(sub["request_tag"]) if sub.get("request_tag")
                   else None)
            if m is not None and m.batcher is not None:
                if tag is None:
                    owned.append((sub_body, None, None))
                    continue
                kind, obj = self._idem_claim(tag)
                if kind == "cached":
                    self.metrics.inc("idempotent_hits")
                    emit(tag, 200, dict(obj, idempotent=True))
                    continue
                if kind == "own":
                    owned.append((sub_body, tag, obj))
                    continue
            threading.Thread(target=run_generic, args=(sub_body, tag),
                             daemon=True).start()
        if owned:
            self._start_owned_batch(m, owned, emit)

        def events():
            for _ in range(len(subs)):   # one line per sub-request
                yield out.get()

        return httpd.jsonl_stream(_request, events())

    def _start_owned_batch(self, m, owned, emit):
        """Build the fresh batched sub-requests, enqueue the valid ones in
        wire order in one call, then wait each out on a thread. A
        sub-request that fails prep or validation answers alone."""
        reqs, metas = [], []
        for sub_body, tag, my_ev in owned:
            t0 = time.time()
            try:
                _, prompt, sp, max_new, seed, extra = self._prep(sub_body)
                req = m.batcher.make_request(
                    prompt, max_new_tokens=max_new, sampling=sp,
                    eos_token_id=m.tokenizer.eos_token_id, seed=seed,
                    kv_export=bool(sub_body.get("kv_export")), **extra)
            except Exception as e:
                # every failure resolves this sub in place: one escaping
                # the loop would leak the earlier subs' inference counts
                # and tag claims
                if my_ev is not None:
                    self._idem_release(tag, my_ev, None)
                st = 400 if isinstance(e, (KeyError, ValueError)) else 500
                emit(tag, st, {"status": "error", "message": str(e)})
                continue
            if not self._try_begin_inference():
                if my_ev is not None:
                    self._idem_release(tag, my_ev, None)
                emit(tag, *_status(self._refuse_draining()))
                continue
            self._note_prefix(m, sub_body, prompt)
            reqs.append(req)
            metas.append((sub_body, tag, my_ev, t0))
        # the peer KV pulls run concurrently: one dead peer's connect
        # timeout then delays the batch once, not once per sub-request
        fetch = [i for i, meta in enumerate(metas)
                 if meta[0].get("kv_source")]
        if fetch:
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=min(8, len(fetch))) as ex:
                for i, pre in zip(fetch, ex.map(
                        lambda i: self._prefetch_kv(
                            m, metas[i][0],
                            reqs[i].prompt + reqs[i].tokens), fetch)):
                    reqs[i]._kv_transfer_bytes = pre
        try:
            m.batcher.enqueue(reqs)
        except Exception as e:
            for _sub_body, tag, my_ev, _t0 in metas:
                if my_ev is not None:
                    self._idem_release(tag, my_ev, None)
                self._end_inference()
                emit(tag, 500, {"status": "error", "message": str(e)})
            return
        for req, meta in zip(reqs, metas):
            threading.Thread(target=self._wait_owned,
                             args=(m, req, emit) + meta, daemon=True).start()

    def _wait_owned(self, m, req, emit, sub_body, tag, my_ev, t0):
        res = None
        st, pl = 500, {"status": "error", "message": "internal error"}
        try:
            st, pl = _status(self._wait_batched(m, req, sub_body, t0))
            res = pl if st == 200 else None
        except Exception as e:
            st, pl = 500, {"status": "error", "message": str(e)}
        finally:
            if my_ev is not None:
                self._idem_release(tag, my_ev, res)
            self._end_inference()
            emit(tag, st, pl)

    def inference_stream(self, body, _request=None):
        """An /inference body answered as server-sent events: one
        ``token`` event per token, then ``done`` or ``error``."""
        stale = self._term_guard(_request)
        if stale:
            return stale
        if not self._try_begin_inference():
            return self._refuse_draining()
        try:
            try:
                m, prompt, sp, max_new, seed, extra = self._prep(body)
            except (KeyError, ValueError) as e:
                return 400, {"status": "error", "message": str(e)}
            q: "queue.Queue" = queue.Queue()
            done = object()
            text = m.tokenizer.decode

            def token(step, tok):
                q.put({"event": "token", "step": step, "token": tok,
                       "text": text([tok])})

            def engine_cb(step, toks):
                if toks[0] is not None:   # None: the sequence finished
                    token(step, toks[0])

            def run():
                try:
                    if m.batcher is None:
                        with m.lock:
                            res = m.engine.generate(
                                [prompt], max_new_tokens=max_new,
                                sampling=sp, seed=seed,
                                eos_token_id=m.tokenizer.eos_token_id,
                                stream_cb=engine_cb, **extra)
                        q.put({"event": "done",
                               "result": text(res.tokens[0]),
                               "tokens_per_s": res.decode_tokens_per_s})
                    else:
                        step = [0]

                        def cb(tok):
                            token(step[0], tok)
                            step[0] += 1

                        pre = self._prefetch_kv(
                            m, body,
                            self._resume_seq(prompt, extra["resume"]),
                            extra["adapter"])
                        req = m.batcher.submit(
                            prompt, max_new_tokens=max_new, sampling=sp,
                            eos_token_id=m.tokenizer.eos_token_id,
                            stream_cb=cb, seed=seed,
                            kv_export=bool(body.get("kv_export")),
                            kv_transfer_bytes=pre, **extra)
                        self._note_prefix(m, body, prompt)
                        toks = req.wait(
                            timeout=float(body.get("timeout", 300)))
                        q.put({"event": "done", "result": text(toks),
                               "ttft_ms": req.ttft_ms})
                except Exception as e:
                    q.put({"event": "error", "message": str(e)})
                q.put(done)

            threading.Thread(target=run, daemon=True).start()

            def events():
                while True:
                    item = q.get()
                    if item is done:
                        break
                    yield item
                self.metrics.inc("requests_completed")

            return httpd.sse_stream(_request, events())
        finally:
            self._end_inference()

    def cancel(self, body, _request=None):
        """Cancel an in-flight tagged batched request: its slot and blocks
        free at the scheduler's next step."""
        stale = self._term_guard(_request)
        if stale:
            return stale
        tag = body.get("request_tag")
        if not tag:
            return 400, {"status": "error", "message": "request_tag required"}
        with self._tagged_lock:
            req = self._tagged.get(str(tag))
        if req is None:
            return 404, {"status": "error",
                         "message": f"no in-flight request tagged {tag!r}"}
        req.cancel()
        self.metrics.inc("requests_cancelled")
        return {"status": "success",
                "message": f"cancel requested for {tag!r}"}

    # ---- the KV plane: roles, transfer --------------------------------

    def set_role(self, body, _request=None):
        """Change this worker's serving role (the master's elastic
        rebalancer): re-advertised on the next /health and in the
        ``worker_role`` gauge; what it is sent, it serves either way."""
        stale = self._term_guard(_request)
        if stale:
            return stale
        role = str(body.get("role") or "").lower()
        if role not in WORKER_ROLES:
            return 400, {"status": "error",
                         "message": f"role must be one of {WORKER_ROLES},"
                                    f" got {role!r}"}
        prev, self.role = self.role, role
        self.metrics.gauge("worker_role", ROLE_CODE[role])
        if prev != role:
            self.metrics.inc("role_flips")
        return {"status": "success", "role": role, "previous": prev}

    def peer_client(self) -> kvwire.KVFetchClient:
        """The peer-fetch client every batched model of this worker
        shares (its auth key, its metrics)."""
        with self._peer_client_lock:
            if self._peer_client is None:
                self._peer_client = kvwire.KVFetchClient(
                    auth_key=self.service.auth_key, metrics=self.metrics)
            return self._peer_client

    def kv_fetch(self, body, _request=None):
        """Stream the host-arena blocks of ``digests`` as kvwire frames,
        each in the form the arena stores it (an int8 arena's records as
        kvq8 frames), then the terminal frame: the digests the arena no
        longer holds are reported missing, and past ``KV_FETCH_MAX_MB``
        the stream is cut and the rest counted as truncated; the peer
        recomputes either."""
        name = body.get("model_name")
        with self._models_lock:
            m = self.models.get(name)
        if m is not None and m.batcher is not None \
                and m.batcher.group is not None:
            return 400, {"status": "error",
                         "message": "/kv_fetch from a batched model under "
                                    "tp or pp is a later slice of the port "
                                    "(ROADMAP Queue A item 9.13)"}
        if m is None or m.batcher is None or m.batcher.kvtier is None:
            return 404, {"status": "error",
                         "message": f"model {name} not serving a KV "
                                    "arena on this worker"}
        digests = body.get("digests")
        if (not isinstance(digests, list) or not digests
                or not all(isinstance(d, str) for d in digests)):
            return 400, {"status": "error",
                         "message": "digests: non-empty list of strings "
                                    "required"}
        if len(digests) > kvwire.MAX_DIGESTS:
            return 400, {"status": "error",
                         "message": f"at most {kvwire.MAX_DIGESTS} "
                                    "digests per fetch"}
        arena = m.batcher.kvtier.arena
        cap = int(KV_FETCH_MAX_MB * 1024 * 1024)
        self.metrics.inc("kv_fetch_requests")

        def frames():
            sent = served = truncated = 0
            missing = []
            for i, d in enumerate(digests):
                obj = arena.peek_stored(d)
                if obj is None:
                    missing.append(d)
                    self.metrics.inc("kv_fetch_missing_blocks")
                    continue
                frame = kvwire.encode_stored(d, obj)
                if sent + len(frame) > cap:
                    truncated = len(digests) - i
                    break
                sent += len(frame)
                served += 1
                self.metrics.inc("kv_fetch_served_blocks")
                self.metrics.inc("kv_fetch_served_bytes", len(frame))
                self.metrics.inc("kv_wire_sent_bytes",
                                 kvwire.stored_nbytes(obj))
                self.metrics.inc("kv_wire_raw_bytes",
                                 kvwire.logical_nbytes(obj))
                yield frame
            yield kvwire.encode_end(served, missing, truncated,
                                    served_bytes=sent)

        return httpd.binary_stream(_request, frames())

    def migrate_out(self, body, _request=None):
        """Live migration of an in-flight tagged batched request (the
        master's rebalancer and drain): its batcher exports the request's
        computed KV into the host arena (where a destination's /kv_fetch
        finds it) and frees its slot at the next step boundary; the
        original dispatch then answers 303 with the resume record. 400
        without a tag, 404 for a tag not in flight, 409 when the request
        completed first (its result stands) or serves in engine mode;
        400 for a batched model under tp (``model_name``); lease-fenced."""
        stale = self._term_guard(_request)
        if stale:
            return stale
        tag = body.get("request_tag")
        if not tag:
            return 400, {"status": "error", "message": "request_tag required"}
        name = body.get("model_name")
        m = self.models.get(name)
        if m is not None and m.batcher is not None \
                and m.batcher.group is not None:
            return 400, {"status": "error",
                         "message": "migration under tp or pp is a later "
                                    "slice of the port (ROADMAP Queue A "
                                    "item 9.14)"}
        with self._tagged_lock:
            req = self._tagged.get(str(tag))
        if req is None:
            return 404, {"status": "error",
                         "message": f"no in-flight request tagged {tag!r}"}
        with self._models_lock:
            models = ([self.models[name]] if name in self.models
                      else list(self.models.values()))
        batcher = next((m.batcher for m in models
                        if m.batcher is not None), None)
        if batcher is None:
            return 409, {"status": "error",
                         "message": "engine-mode requests cannot migrate"}
        rec = batcher.migrate_out(req, timeout=MIGRATE_TIMEOUT_S)
        if rec is None:
            return 409, {"status": "error",
                         "message": f"request {tag!r} completed before "
                                    "the snapshot (or cannot migrate)"}
        self.metrics.inc("requests_migrated_out")
        return {"status": "success", "request_tag": str(tag)}

    @staticmethod
    def _resume_seq(prompt, resume):
        """The sequence whose prefix KV a dispatch prefetches: the prompt,
        and a migrated request's emitted tokens after it."""
        if not isinstance(resume, dict):
            return prompt
        return prompt + [int(t) for t in resume.get("tokens") or []]

    def _prefetch_kv(self, m, body, prompt, adapter=None) -> int:
        """Pull a disaggregated dispatch's prefix KV (its ``kv_source``)
        into the model's arena on this handler thread, so the transfer
        overlaps the batcher's decode loop; the request is then submitted
        without it (a dead peer costs this request a recompute, never the
        scheduler a connect timeout). An adapter request fetches nothing:
        the tier holds base KV only. Returns the bytes moved."""
        src = body.get("kv_source")
        if not src or m.batcher is None or adapter:
            return 0
        return m.batcher.prefetch_kv(prompt, src)

    @staticmethod
    def _note_prefix(m, body, prompt) -> None:
        """Feed a served prompt's text to the prefix-digest advertisement
        (the master routes on text digests; it never tokenizes);
        token-id prompts have no text and are not advertised."""
        b = m.batcher
        if (b is not None and b.kvtier is not None
                and isinstance(body.get("prompt"), str) and body["prompt"]):
            b.kvtier.note_text(body["prompt"], len(prompt))

    # ---- lifecycle -------------------------------------------------------

    def serve(self, host="0.0.0.0", port=8100, background=False):
        return self.service.serve(host, port, background=background)

    def shutdown(self):
        self.service.shutdown()
        with self._models_lock:
            models = list(self.models.values())
        for m in models:
            m.close()
        if self._peer_client is not None:
            self._peer_client.close()


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="PyTorch/CUDA worker agent")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8100)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch path)")
    ap.add_argument("--role", choices=WORKER_ROLES, default=None,
                    help="serving role (default: DLI_WORKER_ROLE, else "
                         "mixed)")
    args = ap.parse_args(argv)
    WorkerAgent(device=args.device, role=args.role).serve(args.host,
                                                          args.port)


if __name__ == "__main__":
    main()
