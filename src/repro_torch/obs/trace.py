"""Causal span tracing, emitted as JSONL when ``REPRO_TRACE`` is set.

A *span* wraps one unit of pipeline work — a scheduler dispatch, a flush, a
writer task, an RPC — and records wall time, thread-CPU time, and whatever
attributes the call site attaches (byte counts, bucket sizes, op names):

    with span("sched.dispatch", bucket=bucket) as sp:
        ...
        sp["rows"] = rows          # attrs can be added mid-span

Spans are *causal*: every span carries a ``trace_id`` (shared by all work
descending from one request), its own ``span_id``, and the ``parent_id``
of the span it ran under.  Parentage is tracked through a thread-local
context stack — a span started while another span is open on the same
thread becomes its child automatically.  Two explicit hand-offs cover the
places the thread-local cannot reach:

* :func:`current_context` captures the active ``(trace_id, span_id)`` —
  cheap, and ``None`` when tracing is off or no span is open;
* :func:`scope` re-installs a captured context on another thread (the
  writer-thread seam: a queued task adopts the flush that enqueued it, so
  queue-wait and store-write time attribute to the request that paid it)
  or from a deserialized wire frame (``shard_server.py`` adopts the
  client's ``rpc.client`` span as the parent of its ``rpc.server`` span —
  the ``trace`` meta entry of protocol VERSION 3).

One JSON object per line (the v2 schema in docs/OBSERVABILITY.md):

    {"ts": <epoch s at span end>, "name": "...", "trace_id": "...",
     "span_id": "...", "parent_id": "..."|absent, "wall_s": ...,
     "cpu_s": ..., "pid": ..., "thread": "...", ...attrs}

``REPRO_TRACE`` selects the sink: a path appends JSONL there (parents
created); ``1``/``stderr`` writes to stderr.  Unset (the default) makes
:func:`span` return a shared no-op whose enter/exit is two attribute
lookups — tracing must cost nothing when it is off, and must never change
results when it is on (CI runs the whole tier-1 suite with it enabled).

The environment variable is re-read on every span start, so tests and
long-lived services can toggle tracing without restarting; the output file
handle is cached per path and writes are serialized under one lock
(spans from writer threads and RPC handlers interleave).  Every record is
flushed line-by-line and the cached handle is closed at interpreter exit
(``atexit``), so a shard server stopped via ``shutdown`` never truncates
its tail spans.

Stdlib-only, like the rest of ``repro_torch.obs`` — shard servers trace too.
"""
from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from typing import Optional, TextIO, Tuple

#: the switch: unset/empty = off; "1"/"stderr" = stderr; else = JSONL path
TRACE_ENV = "REPRO_TRACE"

_lock = threading.Lock()
_sink_path: Optional[str] = None
_sink_file: Optional[TextIO] = None

#: per-thread context stack of (trace_id, span_id) — the causal chain
_tls = threading.local()


def enabled() -> bool:
    """True when ``REPRO_TRACE`` selects a sink (re-read every call)."""
    return bool(os.environ.get(TRACE_ENV))


def _close_sink():
    """Close the cached sink handle (idempotent; registered with atexit so
    a process that exits mid-trace flushes and closes its tail lines)."""
    global _sink_path, _sink_file
    with _lock:
        if _sink_file is not None:
            try:
                _sink_file.close()
            except OSError:
                pass
            _sink_file = None
            _sink_path = None


atexit.register(_close_sink)


def _sink() -> TextIO:
    """The current sink stream (caller holds ``_lock``)."""
    global _sink_path, _sink_file
    target = os.environ.get(TRACE_ENV, "")
    if target in ("1", "stderr"):
        return sys.stderr
    if target != _sink_path or _sink_file is None:
        if _sink_file is not None:
            try:
                _sink_file.close()
            except OSError:
                pass
            _sink_file = None
        parent = os.path.dirname(target)
        if parent:
            os.makedirs(parent, exist_ok=True)
        _sink_file = open(target, "a", encoding="utf-8")
        _sink_path = target
    return _sink_file  # type: ignore[return-value]


def _emit(record: dict):
    line = json.dumps(record, separators=(",", ":"), default=str)
    with _lock:
        try:
            out = _sink()
            # one write + flush per record: concurrent appenders (shard
            # server processes share the path) emit whole lines, and a
            # killed process loses at most the span it was writing
            out.write(line + "\n")
            out.flush()
        except OSError:
            pass  # a torn sink must never take the pipeline down


# -- causal context --------------------------------------------------------------
def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _new_id(nbytes: int = 8) -> str:
    return os.urandom(nbytes).hex()


def current_context() -> Optional[dict]:
    """The active ``{"trace_id", "span_id"}``, or ``None``.

    ``None`` both when tracing is off and when no span is open on this
    thread — callers capture it unconditionally (one attr lookup when
    off) and hand it to :func:`scope` on the far side of a thread or
    process seam.
    """
    st = getattr(_tls, "stack", None)
    if not st:
        return None
    trace_id, span_id = st[-1]
    return {"trace_id": trace_id, "span_id": span_id}


class _Scope:
    """Context manager installing a foreign parent context (see :func:`scope`)."""

    __slots__ = ("_ctx", "_pushed")

    def __init__(self, ctx: Optional[dict]):
        self._ctx = ctx
        self._pushed = False

    def __enter__(self) -> "_Scope":
        ctx = self._ctx
        if ctx and ctx.get("trace_id") and ctx.get("span_id"):
            _stack().append((str(ctx["trace_id"]), str(ctx["span_id"])))
            self._pushed = True
        return self

    def __exit__(self, *exc) -> bool:
        if self._pushed:
            st = _stack()
            if st:
                st.pop()
        return False


def scope(ctx: Optional[dict]) -> _Scope:
    """Adopt a context captured elsewhere as this thread's span parent.

    ``ctx`` is what :func:`current_context` returned on the originating
    thread (or arrived in a wire frame's ``trace`` meta entry); spans
    started inside the ``with`` become its children.  ``None`` or a
    malformed dict is a no-op, so call sites need no ``if`` of their own.
    """
    return _Scope(ctx)


class _NullSpan:
    """Shared do-nothing span for the tracing-off path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __setitem__(self, key, value):
        pass


_NULL = _NullSpan()


class Span:
    """One traced unit of work (use via :func:`span`, not directly)."""

    __slots__ = ("name", "attrs", "_t0", "_c0", "_ids")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "Span":
        st = _stack()
        if st:
            trace_id, parent_id = st[-1]
        else:
            trace_id, parent_id = _new_id(), None
        span_id = _new_id()
        self._ids: Tuple[str, str, Optional[str]] = (
            trace_id, span_id, parent_id
        )
        st.append((trace_id, span_id))
        self._t0 = time.perf_counter()
        self._c0 = time.thread_time()
        return self

    def __exit__(self, etype, exc, tb) -> bool:
        wall = time.perf_counter() - self._t0
        cpu = time.thread_time() - self._c0
        st = _stack()
        if st:  # pop our own frame (LIFO: spans nest on one thread)
            st.pop()
        trace_id, span_id, parent_id = self._ids
        record = {
            "ts": time.time(),
            "name": self.name,
            "trace_id": trace_id,
            "span_id": span_id,
            "wall_s": wall,
            "cpu_s": cpu,
            "pid": os.getpid(),
            "thread": threading.current_thread().name,
        }
        if parent_id is not None:
            record["parent_id"] = parent_id
        if etype is not None:
            record["error"] = etype.__name__
        record.update(self.attrs)
        _emit(record)
        return False  # exceptions always propagate

    def __setitem__(self, key, value):
        self.attrs[key] = value


def span(name: str, **attrs):
    """Start a span named ``name`` with initial attributes ``attrs``.

    Returns the shared no-op when tracing is off, so call sites need no
    ``if`` of their own.
    """
    if not os.environ.get(TRACE_ENV):
        return _NULL
    return Span(name, attrs)
