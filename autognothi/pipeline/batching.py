"""Dynamic (cross-request) micro-batching for the explanation server.

The reference serves nothing (its deployment surface is file-based demos,
/root/reference/scripts/run_image_explanation.py); serve.py adds an HTTP
endpoint with jit-stable fixed-shape slabs.  This module adds the missing
production piece: concurrent requests coalesce into ONE device slab instead
of each padding a slab alone, so under load the padded-slot waste disappears
and device throughput approaches the bench numbers (batch-256+ knees) rather
than the per-request batch.

Design:
- requests enqueue their rows and block; a single dispatcher thread packs a
  FIFO-contiguous, same-row-shape-and-dtype prefix of the queue into a slab
  of at most `batch_size` rows, pads the remainder (edge rows), runs the
  compiled step, and distributes the outputs back;
- a slab launches immediately once `batch_size` rows are pending; a partial
  slab waits at most `window_s` from the moment the oldest pending request
  arrived (window 0 = never wait: coalesce only what is already queued);
- one thread owns all device calls — concurrent HTTP handlers never race on
  the executable (ThreadingHTTPServer handlers previously each called into
  JAX themselves);
- oversized requests span multiple slabs transparently (they keep their
  place at the head of the queue until all their rows are consumed);
- with `depth > 1` the device->host result fetch is pipelined: the
  dispatcher launches slab N+1 while a completer thread finalizes slab N
  (dispatch is async and the result fetch is the synchronous part of a
  serving step, so overlapping it keeps the device busy).

Pure-Python + numpy; the device function is injected (`run_slab`), so tests
exercise the packing logic without a model.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.functional import pad_to

# run_slab: (xs <batch, ...>) -> tuple of per-output arrays, each <batch, ...>.
# May return lazy device arrays; `finalize` (default np.asarray per output)
# materializes them on the completer side.
RunSlab = Callable[[np.ndarray], Tuple[Any, ...]]


class _Request:
    __slots__ = ("xs", "offset", "delivered", "parts", "error", "done",
                 "t_enq")

    def __init__(self, xs: np.ndarray):
        self.xs = xs
        self.offset = 0                      # rows already packed into slabs
        self.delivered = 0                   # rows whose outputs came back
        self.parts: List[Tuple[np.ndarray, ...]] = []  # per-slab output rows
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.t_enq = time.monotonic()        # the coalescing-window anchor

    @property
    def remaining(self) -> int:
        return self.xs.shape[0] - self.offset


class MicroBatcher:
    """Packs rows from concurrent `submit` calls into fixed-size slabs."""

    def __init__(self, run_slab: RunSlab, batch_size: int,
                 window_s: float = 0.003, depth: int = 1,
                 finalize: Optional[Callable[[Tuple[Any, ...]],
                                             Tuple[np.ndarray, ...]]] = None):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._run_slab = run_slab
        self._finalize = finalize or (
            lambda outs: tuple(np.asarray(o) for o in outs))
        self.batch_size = batch_size
        self.window_s = float(window_s)
        self.depth = depth
        self._cv = threading.Condition()
        self._queue: List[_Request] = []
        self._closed = False
        self.slab_count = 0  # diagnostic: slabs collected (incl. failed)
        self.row_count = 0   # real (unpadded) rows dispatched
        self.request_count = 0
        # end-to-end request latencies (enqueue -> last row delivered),
        # bounded ring so /statz percentiles reflect recent traffic
        self._lat_lock = threading.Lock()
        self._latencies: deque = deque(maxlen=1024)
        # depth > 1: in-flight slabs park here; a completer thread pays the
        # device->host fetch while the dispatcher launches the next slab.
        # maxsize bounds in-flight slabs (backpressure on the dispatcher).
        self._inflight: Optional[queue.Queue] = (
            queue.Queue(maxsize=depth - 1) if depth > 1 else None
        )
        self._completer: Optional[threading.Thread] = None
        if self._inflight is not None:
            self._completer = threading.Thread(
                target=self._complete_loop, name="explain-completer",
                daemon=True,
            )
            self._completer.start()
        self._thread = threading.Thread(
            target=self._loop, name="explain-microbatch", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------- client API

    def submit(self, xs: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Block until every row of `xs` has been through the device; returns
        the concatenated per-output arrays (same leading length as xs)."""
        xs = np.asarray(xs)
        if xs.shape[0] == 0:
            raise ValueError("empty batch")
        req = _Request(xs)
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.append(req)
            self.request_count += 1
            self._cv.notify_all()
        req.done.wait()
        if req.error is not None:
            # chain a fresh exception per waiter: re-raising the SAME
            # object from several submitter threads races on its mutable
            # __traceback__/__context__
            raise RuntimeError(
                f"explain slab failed: {req.error!r}") from req.error
        outs = zip(*req.parts)
        return tuple(np.concatenate(rows) for rows in outs)

    def stats(self) -> dict:
        """Occupancy + latency diagnostics: how well concurrent traffic
        packs slabs (occupancy 1.0 = zero padded-slot waste) and the
        end-to-end request latency distribution (enqueue -> last row
        delivered, seconds, over the most recent <=1024 requests)."""
        capacity = self.slab_count * self.batch_size
        with self._lat_lock:
            lat = np.asarray(self._latencies, dtype=np.float64)
        latency = None
        if lat.size:
            p50, p95, p99 = np.percentile(lat, [50.0, 95.0, 99.0])
            latency = {
                "count": int(lat.size),
                "mean_s": round(float(lat.mean()), 6),
                "p50_s": round(float(p50), 6),
                "p95_s": round(float(p95), 6),
                "p99_s": round(float(p99), 6),
                "max_s": round(float(lat.max()), 6),
            }
        return {
            "requests": self.request_count,
            "rows": self.row_count,
            "slabs": self.slab_count,
            "batch_size": self.batch_size,
            "occupancy": (self.row_count / capacity) if capacity else None,
            "latency": latency,
        }

    def close(self) -> None:
        """Drain the queue and stop both threads.  Blocks until every
        pending request has been dispatched and completed — a bounded join
        here could enqueue the completer's sentinel BEFORE the dispatcher's
        final slab, stranding its submitters forever."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join()
        if self._inflight is not None:
            self._inflight.put(None)  # after the dispatcher fully drained
            self._completer.join()

    # --------------------------------------------------------------- dispatch

    def _pending_rows_same_shape(self) -> int:
        """Rows in the FIFO-contiguous prefix sharing the head's row shape
        and dtype (a slab must be homogeneous — it runs one executable)."""
        if not self._queue:
            return 0
        head = self._queue[0].xs
        shape, dtype = head.shape[1:], head.dtype
        total = 0
        for req in self._queue:
            if req.xs.shape[1:] != shape or req.xs.dtype != dtype:
                break
            total += req.remaining
        return total

    def _collect(self):
        """Pop up to batch_size rows from the same-shape FIFO prefix.
        Returns ([(request, start_row, n_rows)], row chunks, unfilled room).
        Pure queue bookkeeping (cannot realistically raise) — the caller
        assembles the slab so a failed concat still knows which requests
        were consumed.  Caller holds the lock."""
        take: List[Tuple[_Request, int, int]] = []
        chunks: List[np.ndarray] = []
        room = self.batch_size
        head = self._queue[0].xs
        shape, dtype = head.shape[1:], head.dtype
        while room and self._queue:
            req = self._queue[0]
            if req.xs.shape[1:] != shape or req.xs.dtype != dtype:
                break
            n = min(room, req.remaining)
            take.append((req, req.offset, n))
            chunks.append(req.xs[req.offset:req.offset + n])
            req.offset += n
            room -= n
            self.row_count += n
            if req.remaining == 0:
                self._queue.pop(0)
        return take, chunks, room

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
                if self.window_s > 0:
                    # the window anchors at the OLDEST pending request's
                    # arrival, not at dispatcher wake-up: a request that
                    # already waited out its budget while the device ran the
                    # previous slab dispatches immediately
                    while (self._queue
                           and self._pending_rows_same_shape()
                           < self.batch_size
                           and not self._closed):
                        oldest = min(r.t_enq for r in self._queue)
                        left = oldest + self.window_s - time.monotonic()
                        if left <= 0:
                            break
                        self._cv.wait(left)
                if not self._queue:
                    # a completer-side _fail can drain the queue while the
                    # lock was released in wait() — never index an empty one
                    continue
                take, chunks, room = self._collect()
                # counted at collect time, like row_count: a failed slab
                # must not leave rows>capacity (occupancy > 1.0) in /statz
                self.slab_count += 1
            try:
                if len(chunks) == 1 and not room:
                    slab = chunks[0]  # zero-copy: one request fills the slab
                else:  # edge-pad with the last row: jit-stable shapes
                    slab = pad_to(np.concatenate(chunks), self.batch_size)
            except BaseException as exc:
                # packing failed (e.g. MemoryError on the concat): fail the
                # consumed requests rather than silently killing the
                # dispatcher thread — every later submit() would hang
                self._fail(take, exc)
                continue
            try:
                outs = self._run_slab(slab)  # possibly lazy device arrays
            except BaseException as exc:  # propagate to every waiter
                self._fail(take, exc)
                continue
            if self._inflight is None:
                self._settle(take, outs)
            else:  # pipelined: the completer pays the fetch for this slab
                self._inflight.put((take, outs))

    # ------------------------------------------------------------- completion

    def _complete_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                return
            self._settle(*item)

    def _settle(self, take, outs) -> None:
        try:
            outs_np = self._finalize(outs)
        except BaseException as exc:  # device errors often surface at fetch
            self._fail(take, exc)
            return
        try:
            used = 0
            for req, _, n in take:
                rows = tuple(o[used:used + n] for o in outs_np)
                used += n
                if req.error is not None:  # an earlier slab failed this one
                    continue
                req.parts.append(rows)
                req.delivered += n
                if req.delivered == req.xs.shape[0]:
                    self._record_latency(req)
                    req.done.set()
        except BaseException as exc:
            # distribution bookkeeping failed (e.g. a run_slab output that
            # violates the per-output <batch, ...> contract): fail the take
            # instead of silently killing this thread — with depth>1 a dead
            # completer eventually blocks the dispatcher on _inflight.put
            # and every later submit() hangs
            self._fail(take, exc)

    def _record_latency(self, req: _Request) -> None:
        with self._lat_lock:
            self._latencies.append(time.monotonic() - req.t_enq)

    def _fail(self, take, exc: BaseException) -> None:
        with self._cv:
            for req, _, _ in take:
                if req.error is None:
                    req.error = exc
                    if req in self._queue:  # drop any unconsumed tail
                        self._queue.remove(req)
                    req.done.set()


def run_concurrent(batcher: MicroBatcher,
                   requests: Sequence[np.ndarray]) -> list:
    """Test/bench helper: submit all `requests` from parallel threads and
    return their results in order."""
    results: list = [None] * len(requests)
    errors: list = [None] * len(requests)

    def worker(i: int, xs: np.ndarray) -> None:
        try:
            results[i] = batcher.submit(xs)
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            errors[i] = exc

    threads = [
        threading.Thread(target=worker, args=(i, xs))
        for i, xs in enumerate(requests)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results
