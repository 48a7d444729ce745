"""Async store writers: block flushing off the ingest thread.

The single-store service does store puts inline with ingest, so SHA-256
hashing and block-file IO serialize with chunking.  The sharded service
instead hands each chunk to its owner shard's :class:`ShardWriter` — one
worker thread per shard, consuming a bounded FIFO queue:

* **one thread per shard** — a shard's ``BlockStore`` (refcount dicts,
  accounting counters, block files) is only ever mutated by its own writer
  thread, so no store needs locks; cross-shard writes proceed in parallel.
* **bounded backpressure** — ``submit`` blocks once ``max_pending`` tasks
  are queued, so a fast ingest thread cannot buffer an unbounded number of
  chunk payloads in memory.
* **crash-safe ordering** — the queue is FIFO and :meth:`barrier` returns
  only after every submitted task ran, so the flush protocol "blocks land,
  *then* recipes commit, *then* manifests sync" holds under async exactly
  as it does inline (the commit/sync steps run on the ingest thread after
  the barrier).

Errors raised by a task are captured and re-raised (first one wins) from
the next :meth:`barrier`/:meth:`close` on the ingest thread — a failed
block write therefore aborts the flush *before* any recipe is committed,
which is the same orphan-blocks-never-dangling-recipes guarantee the sync
path has.

Every writer reports into a :class:`~repro_torch.obs.MetricsRegistry`
(docs/OBSERVABILITY.md): queue depth gauge, backpressure stall-time
counter (seconds ``submit`` spent blocked on a full queue), per-task
queue-wait and flush latency histograms, flushed-byte and error counters —
all labeled by shard.  Metrics outlive a failed flush: the error is
consumed at the barrier but the counters keep counting, so backpressure
and failure rates stay observable across retries.

Tracing crosses the queue: ``submit`` captures the enqueuing thread's
span context (:func:`~repro_torch.obs.current_context`) alongside the task, and
the worker adopts it (:func:`~repro_torch.obs.scope`) around the ``writer.task``
span — so a task's spans (including the shard RPCs it makes) are children
of the *request that enqueued it*, and the recorded queue wait is charged
to the request that paid it, not smeared across whoever happened to be
flushing.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional

from repro_torch.obs import MetricsRegistry, current_context, labeled, scope, span

_STOP = object()


class AsyncWriteError(RuntimeError):
    """A queued store write failed; the flush that submitted it must abort."""


class ShardWriter:
    """One shard's write queue: a single worker thread, bounded FIFO.

    ``max_pending <= 0`` selects synchronous mode: ``submit`` runs the task
    inline and ``barrier`` is a no-op — same interface, no thread, used for
    the sync-flush configuration and as the degenerate 1-shard case.
    ``shard`` labels this writer's metrics; ``registry`` is the owning
    service's (a bare writer gets its own).
    """

    def __init__(self, max_pending: int = 256, name: str = "shard-writer",
                 registry: Optional[MetricsRegistry] = None, shard: int = 0):
        self.async_mode = max_pending > 0
        self._err: Optional[BaseException] = None
        self.obs = registry if registry is not None else MetricsRegistry()
        self._m_depth = labeled("writer.queue_depth", shard=shard)
        self._m_stall = labeled("writer.stall_s", shard=shard)
        self._m_tasks = labeled("writer.tasks", shard=shard)
        self._m_task_s = labeled("writer.task_s", shard=shard)
        self._m_wait_s = labeled("writer.queue_wait_s", shard=shard)
        self._m_bytes = labeled("writer.flushed_bytes", shard=shard)
        self._m_errors = labeled("writer.task_errors", shard=shard)
        if not self.async_mode:
            return
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    def _run_task(self, fn: Callable[[], None], nbytes: int,
                  ctx: Optional[dict] = None,
                  t_enq: Optional[float] = None):
        """Execute one task with timing/accounting; captures the first
        error (re-raised at the barrier) and counts every failure.

        ``ctx``/``t_enq`` arrive from the queue in async mode: the
        enqueuer's span context (adopted so the task traces as a child of
        the request that submitted it) and the enqueue timestamp (the
        delta to now is the queue wait that request paid).  The sync path
        passes neither — the task runs on the submitting thread where the
        context is already live and there is no queue to wait in.
        """
        t0 = time.perf_counter()
        if t_enq is not None:
            self.obs.observe(self._m_wait_s, t0 - t_enq)
        try:
            if self._err is None:  # fail fast: drop work after an error
                with scope(ctx), span("writer.task", bytes=nbytes) as sp:
                    if t_enq is not None:
                        sp["queue_wait_s"] = t0 - t_enq
                    fn()
                self.obs.inc(self._m_bytes, nbytes)
        except BaseException as e:  # noqa: BLE001 — re-raised at barrier
            self._err = e
            self.obs.inc(self._m_errors)
        finally:
            self.obs.inc(self._m_tasks)
            self.obs.observe(self._m_task_s, time.perf_counter() - t0)

    def _loop(self):
        while True:
            task = self._q.get()
            if task is _STOP:
                self._q.task_done()
                return
            try:
                self._run_task(*task)
            finally:
                self._q.task_done()

    def submit(self, fn: Callable[[], None], nbytes: int = 0):
        """Queue one write; blocks when the queue is full (backpressure).

        ``nbytes`` is the task's payload size, counted into the shard's
        ``writer.flushed_bytes`` when the task succeeds.
        """
        if not self.async_mode:
            self._run_task(fn, nbytes)
            return
        # the task carries its enqueuer's span context (the worker adopts
        # it) and the enqueue time (worker-side delta = queue wait)
        task = (fn, nbytes, current_context(), time.perf_counter())
        try:
            self._q.put_nowait(task)
        except queue.Full:
            # backpressure stall: the producer is now blocked until the
            # worker frees a slot — that wait is the metric, not the
            # uncontended enqueue cost (which is sub-microsecond).  The
            # full/blocked decision is one atomic put_nowait: a separate
            # full() pre-check would miss a queue that fills between the
            # check and the put, leaving that stall unmeasured.
            t0 = time.perf_counter()
            self._q.put(task)
            self.obs.inc(self._m_stall, time.perf_counter() - t0)
        self.obs.set_gauge(self._m_depth, self._q.qsize())

    def barrier(self):
        """Wait until every submitted write ran; re-raise the first failure."""
        if self.async_mode:
            self._q.join()
            self.obs.set_gauge(self._m_depth, 0)
        if self._err is not None:
            err, self._err = self._err, None
            raise AsyncWriteError("store write failed during flush") from err

    def close(self):
        """Drain and stop the worker; propagates any pending failure."""
        if self.async_mode and self._thread.is_alive():
            self._q.put(_STOP)
            self._thread.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise AsyncWriteError("store write failed during flush") from err


class WriterPool:
    """Per-shard :class:`ShardWriter` fan-out with a pool-wide barrier."""

    def __init__(self, num_shards: int, max_pending: int = 256,
                 registry: Optional[MetricsRegistry] = None):
        self.obs = registry if registry is not None else MetricsRegistry()
        self.writers: List[ShardWriter] = [
            ShardWriter(max_pending, name=f"shard-writer-{s}",
                        registry=self.obs, shard=s)
            for s in range(num_shards)
        ]

    def submit(self, shard: int, fn: Callable[[], None], nbytes: int = 0):
        self.writers[shard].submit(fn, nbytes)

    def barrier(self):
        """Block until all shards drained; raise the first captured error."""
        first: Optional[BaseException] = None
        for w in self.writers:
            try:
                w.barrier()
            except AsyncWriteError as e:
                first = first or e
        if first is not None:
            raise first

    def close(self):
        first: Optional[BaseException] = None
        for w in self.writers:
            try:
                w.close()
            except AsyncWriteError as e:
                first = first or e
        if first is not None:
            raise first
