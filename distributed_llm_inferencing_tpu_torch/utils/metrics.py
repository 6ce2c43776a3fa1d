"""Process-local metrics registry: counters, gauges, timings, exposition.

Own copy of the reference ``utils/metrics.py``'s registry (``inc``,
``gauge``, ``observe``, ``time``, ``snapshot``, ``prometheus``). The
Prometheus text the worker serves on ``GET /metrics`` follows the text
format contract:

- metric names are sanitized to ``[a-zA-Z_:][a-zA-Z0-9_:]*`` (dots,
  dashes and spaces in registry names become ``_``);
- counters get the ``_total`` suffix, so a counter and a gauge sharing a
  registry name never collide into one exposition line;
- every family carries ``# HELP`` and ``# TYPE`` lines;
- timings export as histograms with cumulative ``le=`` buckets plus
  ``_sum``/``_count``, kept monotone over the process lifetime (a
  shrinking cumulative bucket reads as a counter reset to a Prometheus
  server); ``snapshot()``'s percentiles come from a separate rolling
  window of the last ``WINDOW`` observations.
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from collections import deque
from typing import Dict, List

# Latency-shaped cumulative bucket upper bounds (seconds), wide enough
# for sub-ms decode chunks and multi-minute model loads.
HIST_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)

# Rolling-window size for snapshot() percentiles.
WINDOW = 4096

# The KV plane's counters, under the JAX package's names, registered at 0
# by their owners so a scrape tells "none yet" from "not exported": the
# batcher's host tier and peer transfers (runtime/batcher.py), the
# serving side of /kv_fetch and the role flips (runtime/worker.py), and
# the peer-fetch client's connections (runtime/kvwire.py). The tier's
# gauges: kvtier_host_blocks, kvtier_host_bytes, kvtier_logical_bytes,
# kvtier_occupancy; the worker's: worker_role (0 mixed, 1 prefill, 2
# decode).
KV_TIER_COUNTERS = (
    "kvtier_offloaded_blocks", "kvtier_restored_blocks",
    "kvtier_restored_tokens", "kvtier_exported_blocks",
    "kv_transfer_blocks", "kv_transfer_bytes", "kv_transfer_ms",
    "kv_transfer_failures", "kv_prefetch_coalesced")
KV_SERVE_COUNTERS = (
    "kv_fetch_requests", "kv_fetch_served_blocks", "kv_fetch_served_bytes",
    "kv_fetch_missing_blocks", "kv_wire_raw_bytes", "kv_wire_sent_bytes",
    "role_flips")
KV_PEER_COUNTERS = ("worker_peer_conns_created", "worker_peer_conns_reused",
                    "kv_fetch_queued")

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name: str) -> str:
    """Registry name -> valid Prometheus metric name body."""
    s = _NAME_RE.sub("_", name)
    if not s or s[0].isdigit():
        s = "_" + s
    return s


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._timings: Dict[str, deque] = {}
        # lifetime histogram per timing: [per-bucket counts (last slot =
        # overflow), total count, total sum]; never reset
        self._hist: Dict[str, list] = {}

    def inc(self, name: str, value: float = 1.0):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge(self, name: str, value: float):
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, seconds: float):
        with self._lock:
            self._timings.setdefault(
                name, deque(maxlen=WINDOW)).append(seconds)
            h = self._hist.setdefault(
                name, [[0] * (len(HIST_BUCKETS) + 1), 0, 0.0])
            h[0][bisect.bisect_left(HIST_BUCKETS, seconds)] += 1
            h[1] += 1
            h[2] += seconds

    def time(self, name: str):
        return _Timer(self, name)

    def snapshot(self) -> dict:
        with self._lock:
            out = {"counters": dict(self._counters),
                   "gauges": dict(self._gauges), "timings": {}}
            for k, v in self._timings.items():
                if v:
                    s = sorted(v)
                    out["timings"][k] = {
                        "count": len(s),
                        "p50": s[len(s) // 2],
                        "p95": s[min(len(s) - 1, int(len(s) * 0.95))],
                        "p99": s[min(len(s) - 1, int(len(s) * 0.99))],
                        "mean": sum(s) / len(s),
                        "sum": sum(s),
                    }
            return out

    def prometheus(self) -> str:
        """The registry as Prometheus text exposition (version 0.0.4)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: [list(h[0]), h[1], h[2]]
                     for k, h in self._hist.items()}
        lines: List[str] = []
        for k in sorted(counters):
            name = f"dli_{sanitize_name(k)}_total"
            lines.append(f"# HELP {name} Counter {k!r} (process lifetime).")
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {_fmt(counters[k])}")
        for k in sorted(gauges):
            name = f"dli_{sanitize_name(k)}"
            lines.append(f"# HELP {name} Gauge {k!r} (last set value).")
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_fmt(gauges[k])}")
        for k in sorted(hists):
            per_bucket, count, total = hists[k]
            name = f"dli_{sanitize_name(k)}_seconds"
            lines.append(f"# HELP {name} Timing {k!r} histogram "
                         "(process lifetime).")
            lines.append(f"# TYPE {name} histogram")
            cum = 0
            for le, n in zip(HIST_BUCKETS, per_bucket):
                cum += n
                lines.append(f'{name}_bucket{{le="{_fmt(le)}"}} {cum}')
            lines.append(f'{name}_bucket{{le="+Inf"}} {count}')
            lines.append(f"{name}_sum {_fmt(total)}")
            lines.append(f"{name}_count {count}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    """Exposition-safe number: integral values print without exponent or
    trailing zeros; others as repr floats."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Timer:
    def __init__(self, m: Metrics, name: str):
        self.m, self.name = m, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.m.observe(self.name, time.perf_counter() - self.t0)
