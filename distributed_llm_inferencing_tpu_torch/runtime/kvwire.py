"""Cross-node KV transfer wire: frame codec + worker-side fetch client.

The port's own copy of the JAX package's ``runtime/kvwire.py``; its
frames are byte for byte the JAX package's, so a port worker and a JAX
worker exchange KV blocks over ``POST /kv_fetch``. A prefill-role worker
serves its arena blocks as a stream of length-prefixed binary frames,
and a decode-role worker pulls the blocks it is missing into its own
arena before admission (runtime/batcher.py ``prefetch_kv``), then
restores them like any arena block.

Wire format (one chunked ``application/octet-stream`` response)::

    frame    := MAGIC(4) | hdr_len(u32 BE) | payload_len(u32 BE)
                | hdr(JSON, hdr_len bytes) | payload(payload_len bytes)
    hdr      := {"digest": str, "pages": [{"dtype": str, "shape": [...]},
                 ...]}                          # one block's pages
              | {"digest": str, "quant": "kvq8", "pages": [...specs...],
                 "meta": [{"kind": "raw"|"q8", ...}, ...]}
                                                # int8-quantized block
              | {"end": true, "served": int, "served_bytes": int,
                 "missing": [...], "truncated": int}
                                                # terminal frame, no payload
    payload  := concatenated C-order page bytes, in hdr order

A page's ``dtype`` is numpy's ``dtype.str``; a bfloat16 page's is
``"<V2"``, the string the JAX package's ``ml_dtypes.bfloat16`` pages
carry, and the port decodes it to its host form of bf16 words
(ops/kvblock_quant.py ``BF16``). The payload is the arena entry's exact
bytes, so a restore from a fetched block stays bitwise identical to a
cold prefill. Every structural surprise (bad magic, over-cap lengths,
short read, shape/dtype drift, inconsistent quant meta) raises
:class:`WireError`; the caller treats any failure as "recompute", never
as a request failure.

:class:`KVFetchClient` is the pull side, on the standard library's
``http.client`` where the JAX package uses ``requests`` (a serving node
need not have it): per-peer pooled keep-alive connections with connect
and read timeouts, teardown on connection faults, created-vs-reused
connection accounting (``worker_peer_conns_created/reused``), and an
``rpc:/kv_fetch`` client-side fault point (an injector with the JAX
package's ``intercept(point)`` interface) that cuts the transfer from
the decode node's side of the wire.
"""

from __future__ import annotations

import http.client
import json
import os
import queue
import struct
import threading
import time
import urllib.parse
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from distributed_llm_inferencing_tpu_torch.ops import kvblock_quant as kvq


MAGIC = b"KVF1"
_HDR_STRUCT = struct.Struct(">II")
# Structural sanity caps — a corrupt length prefix must fail fast, not
# allocate gigabytes: one header is a small JSON dict, one payload is one
# KV block's pages (a few MB at most for any real config).
MAX_HDR_BYTES = 1 << 16
MAX_FRAME_PAYLOAD = 256 << 20
# Per-fetch digest-count cap (both sides enforce it): bounds one RPC's
# worst-case working set independently of the byte cap.
MAX_DIGESTS = 4096


class WireError(ValueError):
    """Structurally invalid / truncated / corrupt KV transfer stream."""


class KVFetchError(RuntimeError):
    """Transfer failed at the HTTP layer (non-200, connection fault)."""


def _dtype_str(dt: np.dtype) -> str:
    """A page's wire dtype: numpy's ``dtype.str``, and ``"<V2"`` for the
    host form of bf16, as the JAX package's bf16 pages are labelled."""
    return "<V2" if dt == kvq.BF16 else dt.str


def encode_frame(digest: str, pages: Sequence[np.ndarray]) -> bytes:
    """One block's pages as a self-describing binary frame."""
    pages = [np.ascontiguousarray(p) for p in pages]
    hdr = json.dumps({
        "digest": str(digest),
        "pages": [{"dtype": _dtype_str(p.dtype), "shape": list(p.shape)}
                  for p in pages]}).encode()
    payload = b"".join(p.tobytes() for p in pages)
    return MAGIC + _HDR_STRUCT.pack(len(hdr), len(payload)) + hdr + payload


def encode_kvq_frame(digest: str, record: dict) -> bytes:
    """One int8-quantized block record as a ``kvq8`` frame: the stored
    q/scale arrays ship as-is (no requantize on send), the header's
    ``meta`` tells the receiver how to reassemble and validate them."""
    arrays = [np.ascontiguousarray(a) for a in kvq.wire_arrays(record)]
    hdr = json.dumps({
        "digest": str(digest), "quant": "kvq8",
        "pages": [{"dtype": _dtype_str(a.dtype), "shape": list(a.shape)}
                  for a in arrays],
        "meta": kvq.wire_meta(record)}).encode()
    payload = b"".join(a.tobytes() for a in arrays)
    return MAGIC + _HDR_STRUCT.pack(len(hdr), len(payload)) + hdr + payload


def encode_stored(digest: str, obj) -> bytes:
    """Frame for whatever representation the arena stored — raw page
    tuple or quantized record — without converting either way."""
    if kvq.is_quantized_block(obj):
        return encode_kvq_frame(digest, obj)
    return encode_frame(digest, obj)


def stored_nbytes(obj) -> int:
    """Payload bytes ``encode_stored`` will ship for an arena entry."""
    if kvq.is_quantized_block(obj):
        return kvq.stored_nbytes(obj)
    return sum(int(p.nbytes) for p in obj)


def logical_nbytes(obj) -> int:
    """Full-precision bytes the entry restores to (the raw-wire cost a
    quantized transfer avoided — the compression accounting's numerator)."""
    if kvq.is_quantized_block(obj):
        return kvq.logical_nbytes(obj)
    return sum(int(p.nbytes) for p in obj)


def encode_end(served: int, missing: Sequence[str],
               truncated: int = 0, served_bytes: int = 0) -> bytes:
    """Terminal frame: how the stream ended, so a short-but-clean close
    is distinguishable from a mid-stream disconnect. The missing LIST is
    capped (a 4096-digest fetch against a cold arena would otherwise
    build a header past the decoder's MAX_HDR_BYTES and fail the whole
    stream); ``missing_count`` always carries the true total, and
    ``served``/``served_bytes`` carry what actually crossed the wire so
    a size-capped partial sizes its recompute fallback honestly."""
    missing = list(missing)
    hdr = json.dumps({"end": True, "served": int(served),
                      "served_bytes": int(served_bytes),
                      "missing": missing[:256],
                      "missing_count": len(missing),
                      "truncated": int(truncated)}).encode()
    return MAGIC + _HDR_STRUCT.pack(len(hdr), 0) + hdr


class _StreamReader:
    """Exact-count reads over an iterator of byte chunks."""

    def __init__(self, chunks: Iterable[bytes]):
        self._it = iter(chunks)
        self._buf = bytearray()

    def read(self, n: int) -> bytes:
        while len(self._buf) < n:
            try:
                chunk = next(self._it)
            except StopIteration:
                raise WireError(
                    f"stream truncated: wanted {n} bytes, "
                    f"got {len(self._buf)}")
            if chunk:
                self._buf.extend(chunk)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


def iter_frames(chunks: Iterable[bytes],
                max_total_bytes: Optional[int] = None):
    """Incrementally decode a /kv_fetch stream: yields
    ``("block", digest, obj)`` per block frame — ``obj`` is the page
    list for raw frames or the quantized record for ``kvq8`` frames —
    then ``("end", hdr)`` for the terminal frame, exactly once. Raises
    :class:`WireError` on any structural problem, including a stream
    that ends without its terminal frame (a mid-stream disconnect must
    not pass for a clean short answer). The streaming restore path
    consumes this a frame at a time so scatter of block N can overlap
    receive of block N+1."""
    rd = _StreamReader(chunks)
    total = 0
    while True:
        head = rd.read(4 + _HDR_STRUCT.size)
        if head[:4] != MAGIC:
            raise WireError("bad frame magic (corrupt stream)")
        hdr_len, payload_len = _HDR_STRUCT.unpack(head[4:])
        if hdr_len > MAX_HDR_BYTES or payload_len > MAX_FRAME_PAYLOAD:
            raise WireError("frame length prefix out of bounds")
        try:
            hdr = json.loads(rd.read(hdr_len))
        except ValueError:
            raise WireError("unparseable frame header")
        if not isinstance(hdr, dict):
            raise WireError("frame header is not an object")
        if hdr.get("end"):
            yield ("end", hdr)
            return
        total += payload_len
        if max_total_bytes is not None and total > max_total_bytes:
            raise WireError(f"stream exceeds byte cap ({max_total_bytes})")
        payload = rd.read(payload_len)
        digest = hdr.get("digest")
        specs = hdr.get("pages")
        if not isinstance(digest, str) or not isinstance(specs, list):
            raise WireError("frame header missing digest/pages")
        pages, off = [], 0
        for spec in specs:
            try:
                dt = np.dtype(spec["dtype"])
                shape = tuple(int(s) for s in spec["shape"])
            except (KeyError, TypeError, ValueError):
                raise WireError("bad page spec in frame header")
            nbytes = dt.itemsize * int(np.prod(shape, dtype=np.int64))
            if off + nbytes > len(payload):
                raise WireError("frame payload shorter than page specs")
            # read-only view into the payload bytes, NOT a copy: the
            # fetch runs on a worker handler thread, and per-page copies
            # are GIL time stolen from the decode loop (the arena stores
            # the views; the payload bytes stay alive through them)
            pages.append(np.frombuffer(
                payload, dtype=dt, count=nbytes // dt.itemsize,
                offset=off).reshape(shape))
            off += nbytes
        if off != len(payload):
            raise WireError("frame payload longer than page specs")
        if hdr.get("quant") is not None:
            if hdr["quant"] != "kvq8":
                raise WireError(
                    f"unknown frame quant scheme {hdr['quant']!r}")
            meta = hdr.get("meta")
            if not isinstance(meta, list):
                raise WireError("kvq8 frame missing meta")
            # the meta crossed the wire: every shape/dtype relationship
            # it declares is validated before the record is trusted
            try:
                obj = kvq.block_from_wire(meta, pages)
            except ValueError as e:
                raise WireError(str(e))
            yield ("block", digest, obj)
        else:
            yield ("block", digest, pages)


def decode_frames(chunks: Iterable[bytes],
                  max_total_bytes: Optional[int] = None
                  ) -> Tuple[Dict[str, object], dict]:
    """Parse a whole /kv_fetch response stream into {digest: block}
    (pages list or quantized record) plus the terminal frame's header."""
    out: Dict[str, object] = {}
    for item in iter_frames(chunks, max_total_bytes=max_total_bytes):
        if item[0] == "end":
            return out, item[1]
        out[item[1]] = item[2]
    raise WireError("stream ended without terminal frame")


class FetchStream:
    """One in-flight streaming /kv_fetch: a receiver thread pumps the
    socket through the frame decoder into a bounded queue while the
    caller consumes blocks, so the caller's work on block N overlaps the
    receive of block N+1.

    Iterate to get ``(digest, block)`` pairs (block = page list or
    quantized record); after clean exhaustion ``end`` holds the terminal
    frame's header. Transport and stream faults re-raise in the consumer
    as :class:`KVFetchError` / :class:`WireError` (the peer's pooled
    connections purged). Abandoning the iterator early closes the
    response and drains the queue, so the receiver thread always exits
    and the client's concurrency slot is always released."""

    def __init__(self, client: "KVFetchClient", base_url: str, conn, resp,
                 allowed, depth: int):
        self._client = client
        self._base_url = base_url
        self._conn = conn
        self._resp = resp
        self._allowed = allowed
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self.end: Optional[dict] = None
        self.receiving_done = False
        self._finished = False
        self._thread = threading.Thread(
            target=self._pump, name="dli-kvwire-recv", daemon=True)
        self._thread.start()

    def _pump(self) -> None:
        clean = False
        try:
            for item in iter_frames(_chunks(self._resp),
                                    max_total_bytes=self._client.max_bytes):
                if item[0] == "end":
                    self._resp.read()   # the chunked body's terminator
                    clean = True
                    self.receiving_done = True
                self._q.put(item)
        except WireError as e:
            self._q.put(e)
        except _TRANSPORT as e:
            self._q.put(KVFetchError(f"kv_fetch transport failed: {e}"))
        finally:
            self.receiving_done = True
            if clean and not self._resp.will_close:
                self._client._release(self._base_url, self._conn)
            else:
                self._conn.close()

    def __iter__(self):
        try:
            while True:
                item = self._q.get()
                if isinstance(item, Exception):
                    self._client.purge(self._base_url)
                    raise item
                if item[0] == "end":
                    self.end = item[1]
                    return
                _, digest, obj = item
                if digest in self._allowed:
                    yield digest, obj
        finally:
            self._finish()

    def _finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        if not self.receiving_done:
            self._conn.close()   # unblocks a receiver stuck in a read
        # drain until the receiver exits: it may be blocked on a full
        # queue, and the concurrency slot must not leak with it
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                self._thread.join(timeout=0.05)
        self._client._sem.release()


# what a connection fault raises: socket errors (refused, reset, timed
# out; ConnectionError and TimeoutError are OSErrors) and malformed HTTP
_TRANSPORT = (OSError, http.client.HTTPException)


def _chunks(resp, size: int = 1 << 18):
    """The body of ``resp`` as an iterator of byte chunks (http.client
    undoes the chunked framing)."""
    while True:
        data = resp.read(size)
        if not data:
            return
        yield data


class KVFetchClient:
    """Decode-side puller: fetch arena blocks from a peer worker over the
    standard library's ``http.client`` (a serving node need not have
    ``requests``).

    Per peer, a pool of at most ``pool_size`` idle keep-alive
    connections; the connect timeout bounds the dial and the read
    timeout every read, so a black-holed peer fails in seconds; a
    connection fault purges the peer's pooled connections, so a
    restarted peer never feeds the next fetch a dead socket (a pooled
    connection the peer closed while idle is redialled once). Dialled
    and reused connections are counted (``worker_peer_conns_created`` /
    ``_reused``) in the worker's registry. Thread-safe; shared by every
    batcher a worker hosts.
    """

    def __init__(self, auth_key: Optional[str] = None, faults=None,
                 metrics=None, connect_timeout: float = 5.0,
                 read_timeout: float = 30.0,
                 max_mb: Optional[float] = None, pool_size: int = 2):
        from distributed_llm_inferencing_tpu_torch.utils.metrics import (
            KV_PEER_COUNTERS, Metrics)
        self.auth_key = auth_key
        self.faults = faults
        self.metrics = metrics or Metrics()
        self.timeout = (float(connect_timeout), float(read_timeout))
        if max_mb is None:
            try:
                max_mb = float(os.environ.get("DLI_KV_FETCH_MAX_MB", 256))
            except ValueError:
                max_mb = 256.0
        self.max_bytes = int(max_mb * 1024 * 1024)
        self._pool_size = max(1, int(pool_size))
        self._idle: Dict[str, List[http.client.HTTPConnection]] = {}
        self._lock = threading.Lock()
        # peer-fetch concurrency bound: fetches past it queue on the
        # semaphore and are counted, so a pile-up shows before it is a
        # timeout
        try:
            conc = int(os.environ.get("DLI_KV_FETCH_CONCURRENCY", 4))
        except ValueError:
            conc = 4
        self._sem = threading.BoundedSemaphore(max(1, conc))
        # blocks queued between the receiver thread and the consumer
        try:
            qd = int(os.environ.get("DLI_KV_WIRE_QUEUE", 4))
        except ValueError:
            qd = 4
        self.queue_depth = max(1, qd)
        for name in KV_PEER_COUNTERS:
            self.metrics.inc(name, 0)

    def _dial(self, base_url: str) -> http.client.HTTPConnection:
        u = urllib.parse.urlsplit(base_url)
        cls = (http.client.HTTPSConnection if u.scheme == "https"
               else http.client.HTTPConnection)
        conn = cls(u.hostname, u.port, timeout=self.timeout[0])
        conn.connect()
        conn.sock.settimeout(self.timeout[1])
        self.metrics.inc("worker_peer_conns_created")
        return conn

    def _release(self, base_url: str, conn) -> None:
        with self._lock:
            idle = self._idle.setdefault(base_url, [])
            if len(idle) < self._pool_size:
                idle.append(conn)
                return
        conn.close()

    def purge(self, base_url: str) -> None:
        """Drop the peer's pooled connections after a connection fault."""
        with self._lock:
            idle = self._idle.pop(base_url, [])
        for conn in idle:
            conn.close()

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, {}
        for conns in idle.values():
            for conn in conns:
                conn.close()

    def _rpc_fault(self, path: str) -> None:
        """Client-side fault point ``rpc:/kv_fetch``: cut the transfer from
        the decode node's side without touching the peer process."""
        if self.faults is None:
            return
        f = self.faults.intercept(f"rpc:{path}")
        if f is None:
            return
        if f.mode == "latency":
            time.sleep(f.delay_s)
            return
        if f.delay_s:
            time.sleep(f.delay_s)
        if f.mode == "timeout":
            raise TimeoutError("injected kv_fetch timeout")
        raise ConnectionError("injected kv_fetch fault")

    def _post(self, base_url: str, model: str, digests: List[str]):
        """POST /kv_fetch on a pooled connection (a fresh one when the
        pooled one was closed by the peer): (connection, response)."""
        path = urllib.parse.urlsplit(base_url).path + "/kv_fetch"
        body = json.dumps({"model_name": model,
                           "digests": digests}).encode()
        headers = {"Content-Type": "application/json"}
        if self.auth_key:
            headers["Authorization"] = f"Bearer {self.auth_key}"
        with self._lock:
            idle = self._idle.get(base_url)
            conn = idle.pop() if idle else None
        if conn is not None:
            try:
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
                self.metrics.inc("worker_peer_conns_reused")
                return conn, resp
            except _TRANSPORT:
                conn.close()   # the peer closed it while it was idle
        conn = None
        try:
            conn = self._dial(base_url)
            conn.request("POST", path, body=body, headers=headers)
            return conn, conn.getresponse()
        except _TRANSPORT as e:
            if conn is not None:
                conn.close()
            self.purge(base_url)
            raise KVFetchError(f"kv_fetch transport failed: {e}")

    def _open(self, base_url: str, model: str, digests: Sequence[str]):
        """Take a concurrency slot and open the stream: (base_url,
        digests, connection, response). Refusals raise with the slot
        released."""
        base_url = base_url.rstrip("/")
        digests = [str(d) for d in digests][:MAX_DIGESTS]
        if not self._sem.acquire(blocking=False):
            self.metrics.inc("kv_fetch_queued")
            self._sem.acquire()
        try:
            try:
                self._rpc_fault("/kv_fetch")
            except _TRANSPORT as e:
                self.purge(base_url)
                raise KVFetchError(f"kv_fetch transport failed: {e}")
            conn, resp = self._post(base_url, model, digests)
            if resp.status != 200:
                text = resp.read()[:200].decode("utf-8", "replace")
                conn.close()
                raise KVFetchError(f"kv_fetch refused ({resp.status}): "
                                   f"{text}")
        except BaseException:
            self._sem.release()
            raise
        return base_url, digests, conn, resp

    def fetch(self, base_url: str, model: str, digests: Sequence[str]
              ) -> Dict[str, object]:
        """Pull ``digests``' blocks from the peer's arena. Returns only the
        blocks the peer served (absent digests are the caller's recompute,
        not an error). Raises :class:`KVFetchError` / :class:`WireError`
        on a transport fault or a corrupt stream (the caller recomputes).
        No Content-Type gate: a 200 with a body that is not a frame
        stream fails the magic check."""
        return dict(self.fetch_stream(base_url, model, digests))

    def fetch_stream(self, base_url: str, model: str,
                     digests: Sequence[str]) -> FetchStream:
        """Streaming :meth:`fetch`: a :class:`FetchStream` whose iterator
        hands blocks over as their frames decode. Connect-time refusals
        raise here; mid-stream faults raise from the iterator. The
        concurrency slot is held until the stream finishes."""
        base_url, digests, conn, resp = self._open(base_url, model, digests)
        return FetchStream(self, base_url, conn, resp, set(digests),
                           self.queue_depth)
