"""Thread-safe metrics registry: counters, gauges, log-bucketed histograms.

The always-on measurement substrate for the dedup service (the catalog of
every instrumented name lives in docs/OBSERVABILITY.md).  Three metric
kinds, all behind one lock per registry:

* **counters** — monotonically increasing totals (ints or float seconds);
* **gauges**   — last-written values (queue depth, per-bucket occupancy);
* **histograms** — log-bucketed distributions (latencies, sizes) exporting
  count/sum/min/max and p50/p95/p99 without retaining samples.

Histogram buckets are geometric with :data:`BUCKETS_PER_OCTAVE` buckets per
factor of two (ratio ``2**(1/4) ~ 1.19``), so a bucket index is
``ceil(log(v) / log(ratio))`` and a quantile is resolved to the geometric
midpoint of its bucket — at most ~9% relative error, constant memory,
O(1) per observation.  Non-positive observations land in a dedicated
underflow bucket and report as 0.0.

Label convention: a *labeled* metric name is rendered by :func:`labeled`
as ``name{k=v,...}`` with keys sorted, so the same (name, labels) pair is
always the same string and snapshots diff cleanly across runs.  Labeled
series are *capped per family* (the part before the ``{``): once a family
holds ``max_labeled_series`` distinct label combinations, further new
combinations are dropped and counted in ``obs.series_dropped{family=}``
instead of growing the registry without bound (the ``{bucket=,packed=}``
gauge families grow per observed shape, and a hostile or buggy label
value — say a raw stream name — must not OOM a long-lived server).
Unlabeled series and existing labeled series are never dropped.

Snapshots are plain JSON-serializable dicts; :func:`merge_snapshots` folds
many of them (the per-shard-server snapshots gathered over the wire by
``ShardedDedupService.metrics()``) into one aggregate: counters and
histogram buckets sum, gauges sum too (documented — a summed queue depth
is the fleet's total backlog; per-shard values remain in the unmerged
snapshots).

Everything here is stdlib-only: the numpy-only shard server processes
import this module, so it must never pull in jax or numpy.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

#: geometric histogram resolution: 4 buckets per factor of two
BUCKETS_PER_OCTAVE = 4

_RATIO = 2.0 ** (1.0 / BUCKETS_PER_OCTAVE)
_LOG_RATIO = math.log(_RATIO)

#: bucket index for non-positive observations (sorts below every real one)
_UNDERFLOW = -(10**9)


def bucket_index(value: float) -> int:
    """Index of the geometric bucket ``(ratio**(i-1), ratio**i]`` holding
    ``value``; non-positive values go to the underflow bucket."""
    if value <= 0.0:
        return _UNDERFLOW
    # ceil with a tolerance so exact powers of the ratio stay in their own
    # bucket instead of flipping on float noise
    return math.ceil(math.log(value) / _LOG_RATIO - 1e-9)


def bucket_value(index: int) -> float:
    """Representative value (geometric midpoint) of a bucket index."""
    if index == _UNDERFLOW:
        return 0.0
    return _RATIO ** (index - 0.5)


class _Histogram:
    __slots__ = ("count", "total", "vmin", "vmax", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.buckets: Dict[int, int] = {}

    def observe(self, value: float):
        self.count += 1
        self.total += value
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value
        i = bucket_index(value)
        self.buckets[i] = self.buckets.get(i, 0) + 1


def _quantiles(buckets: Dict[int, int], count: int,
               qs: Iterable[float]) -> List[float]:
    """Quantiles resolved to bucket midpoints from a bucket->count map."""
    if not count:
        return [0.0 for _ in qs]
    order = sorted(buckets)
    out = []
    for q in qs:
        rank = q * count
        cum = 0.0
        val = bucket_value(order[-1])
        for i in order:
            cum += buckets[i]
            if cum >= rank:
                val = bucket_value(i)
                break
        out.append(val)
    return out


def _hist_export(count: int, total: float, vmin: float, vmax: float,
                 buckets: Dict[int, int]) -> dict:
    p50, p95, p99 = _quantiles(buckets, count, (0.50, 0.95, 0.99))
    return {
        "count": count,
        "sum": total,
        "min": vmin if count else 0.0,
        "max": vmax if count else 0.0,
        "mean": total / count if count else 0.0,
        "p50": p50,
        "p95": p95,
        "p99": p99,
        # JSON object keys must be strings; kept sorted for stable diffs
        "buckets": {str(i): buckets[i] for i in sorted(buckets)},
    }


def labeled(name: str, **labels) -> str:
    """Render ``name{k=v,...}`` with sorted keys — the one label syntax."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class _Timer:
    """``with registry.time("x.latency_s"):`` — observes elapsed seconds."""

    __slots__ = ("_reg", "_name", "_t0")

    def __init__(self, reg: "MetricsRegistry", name: str):
        self._reg = reg
        self._name = name

    def __enter__(self) -> "_Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._reg.observe(self._name, time.perf_counter() - self._t0)
        return False


class MetricsRegistry:
    """One process-visible bag of counters/gauges/histograms (thread-safe).

    Each service instance owns a registry (so tests don't cross-pollute);
    each shard server process owns one, exported over the wire by the
    ``metrics`` op.  All mutators are O(1) under one lock — cheap enough
    for the per-dispatch / per-RPC / per-writer-task granularity the
    service instruments at (the overhead contract in
    docs/OBSERVABILITY.md), but not for per-byte loops.
    """

    #: default per-family cap on distinct labeled series (far above the
    #: widest legitimate family — ~40 length buckets x 2 packed states)
    DEFAULT_MAX_LABELED_SERIES = 256

    def __init__(self, max_labeled_series: int = DEFAULT_MAX_LABELED_SERIES):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Histogram] = {}
        self._max_labeled_series = max_labeled_series
        # per-kind family -> count of distinct labeled series admitted
        self._families: Dict[str, Dict[str, int]] = {
            "counter": {}, "gauge": {}, "hist": {},
        }

    def _admit(self, kind: str, store: dict, name: str) -> bool:
        """Whether a write to ``name`` may proceed (caller holds the lock).

        Existing series and unlabeled names (a fixed, code-enumerated set)
        always pass; a *new* labeled series passes only while its family is
        under the cap, else it is dropped and tallied in
        ``obs.series_dropped{family=}`` (written directly to the counter
        store — the overflow counter itself is exempt from the guard).
        """
        if name in store:
            return True
        brace = name.find("{")
        if brace < 0:
            return True
        family = name[:brace]
        fams = self._families[kind]
        n = fams.get(family, 0)
        if n >= self._max_labeled_series:
            dropped = labeled("obs.series_dropped", family=family)
            self._counters[dropped] = self._counters.get(dropped, 0) + 1
            return False
        fams[family] = n + 1
        return True

    # -- mutators ---------------------------------------------------------------
    def inc(self, name: str, value: float = 1):
        """Add ``value`` (default 1) to a monotonic counter."""
        with self._lock:
            if self._admit("counter", self._counters, name):
                self._counters[name] = self._counters.get(name, 0) + value

    def set_gauge(self, name: str, value: float):
        """Record the current value of a gauge (last write wins)."""
        with self._lock:
            if self._admit("gauge", self._gauges, name):
                self._gauges[name] = value

    def observe(self, name: str, value: float):
        """Add one observation to a log-bucketed histogram."""
        with self._lock:
            if not self._admit("hist", self._hists, name):
                return
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Histogram()
            h.observe(value)

    def time(self, name: str) -> _Timer:
        """Context manager observing elapsed wall seconds into ``name``."""
        return _Timer(self, name)

    # -- export -----------------------------------------------------------------
    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def gauge(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def snapshot(self) -> dict:
        """JSON-serializable copy of everything (percentiles precomputed)."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    n: _hist_export(h.count, h.total, h.vmin, h.vmax,
                                    h.buckets)
                    for n, h in sorted(self._hists.items())
                },
            }

    def clear(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            for fams in self._families.values():
                fams.clear()


class _Phase:
    """Context manager arm of :meth:`PhaseClock.phase`."""

    __slots__ = ("_clock", "_name")

    def __init__(self, clock: "PhaseClock", name: str):
        self._clock = clock
        self._name = name

    def __enter__(self) -> "_Phase":
        self._clock._push(self._name)
        return self

    def __exit__(self, *exc):
        self._clock._pop()
        return False


class PhaseClock:
    """Partition one request's wall time into named phases, exactly.

    The clock starts at construction with an implicit bottom phase
    (``"other"``); ``with clock.phase("fp"):`` accrues the enclosed wall
    time to ``fp`` (phases nest — the inner phase owns the time while it
    is open).  :meth:`move` reattributes seconds measured elsewhere (the
    scheduler's host tail redo happens *inside* the dispatch call, so the
    service moves its reported seconds from ``chunk-dispatch`` to
    ``tail`` after the fact).  :meth:`stop` closes the clock and returns
    ``(total, phases)`` where ``sum(phases.values()) == total`` *by
    construction* — every elapsed instant belongs to exactly one phase —
    which is what lets the ``req.latency_s{op=,phase=}`` histograms
    reconcile against the request root span's wall time.

    Single-threaded by design: one clock lives on one request's calling
    thread (work done on writer threads is observed from the calling
    thread as queue-wait/barrier phases, not by sharing the clock).
    """

    OTHER = "other"

    def __init__(self):
        self._t0 = time.perf_counter()
        self._last = self._t0
        self._stack: List[str] = [self.OTHER]
        self._phases: Dict[str, float] = {}
        self._total: Optional[float] = None

    def _accrue(self):
        now = time.perf_counter()
        top = self._stack[-1]
        self._phases[top] = self._phases.get(top, 0.0) + (now - self._last)
        self._last = now

    def _push(self, name: str):
        self._accrue()
        self._stack.append(name)

    def _pop(self):
        self._accrue()
        self._stack.pop()

    def phase(self, name: str) -> _Phase:
        """Accrue the wall time of the ``with`` body to phase ``name``."""
        return _Phase(self, name)

    def move(self, src: str, dst: str, seconds: float):
        """Reattribute up to ``seconds`` already accrued to ``src`` onto
        ``dst`` (clamped so no phase goes negative and the sum is
        preserved)."""
        seconds = max(0.0, min(seconds, self._phases.get(src, 0.0)))
        if seconds <= 0.0:
            return
        self._phases[src] -= seconds
        self._phases[dst] = self._phases.get(dst, 0.0) + seconds

    def stop(self) -> Tuple[float, Dict[str, float]]:
        """Close the clock: returns ``(total_s, {phase: seconds})`` with
        the phases summing to the total exactly.  Idempotent."""
        if self._total is None:
            while len(self._stack) > 1:  # abandoned phases (error paths)
                self._pop()
            self._accrue()
            self._total = self._last - self._t0
        return self._total, dict(self._phases)


def merge_snapshots(snaps: Iterable[Optional[dict]]) -> dict:
    """Fold many :meth:`MetricsRegistry.snapshot` dicts into one aggregate.

    Counters sum; gauges sum (a summed queue depth is the fleet backlog —
    per-shard values stay in the unmerged snapshots); histograms merge
    bucket-wise and re-derive their percentiles, so the aggregate p99 is
    the true p99 of the union, not an average of per-shard p99s.
    ``None`` entries (an unreachable shard) are skipped.
    """
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, dict] = {}  # name -> {count,sum,min,max,buckets{int:n}}
    for s in snaps:
        if not s:
            continue
        for k, v in s.get("counters", {}).items():
            counters[k] = counters.get(k, 0) + v
        for k, v in s.get("gauges", {}).items():
            gauges[k] = gauges.get(k, 0) + v
        for name, h in s.get("histograms", {}).items():
            acc = hists.setdefault(
                name,
                {"count": 0, "sum": 0.0, "min": math.inf, "max": -math.inf,
                 "buckets": {}},
            )
            acc["count"] += h["count"]
            acc["sum"] += h["sum"]
            if h["count"]:
                acc["min"] = min(acc["min"], h["min"])
                acc["max"] = max(acc["max"], h["max"])
            for i, n in h.get("buckets", {}).items():
                i = int(i)
                acc["buckets"][i] = acc["buckets"].get(i, 0) + n
    return {
        "counters": counters,
        "gauges": gauges,
        "histograms": {
            n: _hist_export(a["count"], a["sum"], a["min"], a["max"],
                            a["buckets"])
            for n, a in sorted(hists.items())
        },
    }
