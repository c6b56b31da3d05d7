"""The pack stream: one queue of members for a ``HostPacker``, worked by
a pool of the packer's workers across batches and timesteps.

A batch handed to :meth:`PackStream.submit` becomes a record of members
and the call returns at once, with a ``Future`` of the record's bytes.
Each member runs in two stages on the pool: ``size`` (its kept count,
which sets its payload's length: well under a ms) and ``encode`` (the
whole member: mask, RLE, serialize, xz and, in files mode, its write;
seconds for a large member).  A free worker takes a queued ``size``
before any ``encode``, so that every queued member's size is known when
the encodes are ordered, and then the queued ``encode`` of the largest
payload, of whatever batch (longest processing time first; ties in
submission order).  No batch waits for another: the pool idles only
when the queue is empty.  Workers are threads started when work is
queued and ending when the queue is empty, so a stream holds no thread
while it is idle and needs no shutdown.

Bundle mode appends each record's blobs in (record, member) order and
runs a close (:meth:`close_later`) once every record submitted before it
has been appended, so the bytes equal a one-worker, one-batch-at-a-time
pack's.  One thread appends at a time; it is a worker whose member made
the next blob ready.

A failure in any task fails its record and every record submitted after
it, closes included, and sticks: later submits and closes fail with the
same exception, so no later bundle is closed as complete.  Records
submitted before it run to their end.

Counters, added to ``stats`` under the stream's lock: ``pack_seconds``,
the union of the intervals in which a record is in flight (from its
submit to its last member written or appended), so that overlapping
batches are not counted twice; the counters each stage returns (the
packer's ``pack_cpu_seconds``, ``xz_in_bytes``, ``xz_cpu_seconds``); and,
for the blocks that :meth:`overlap` wraps, ``pack_overlap_seconds``,
their seconds in which a record was in flight.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import heapq
import itertools
import threading
import time

__all__ = ["PackStream"]

_EMPTY = object()       # a member slot not yet filled


class _Record:
    """A submitted batch (``items`` set) or a bundle close (``close``)."""

    __slots__ = ("seq", "future", "nbytes", "out_dir", "items", "outs",
                 "left", "next", "total", "close", "failed")

    def __init__(self, seq, nbytes=0, out_dir=None, items=None,
                 close=None):
        self.seq = seq
        self.future = cf.Future()
        self.future.set_running_or_notify_cancel()
        self.nbytes = nbytes
        self.out_dir = out_dir
        self.items = items
        self.outs = [_EMPTY] * len(items) if items is not None else None
        self.left = len(items) if items is not None else 0
        self.next = 0           # bundle mode: the next member to append
        self.total = 0
        self.close = close      # (t,) for a close record; t None: all
        self.failed = False


class PackStream:
    """The packer's queue of members and the pool that works it.

    ``workers``: the most threads at once.  ``append(out_dir, item,
    blob) -> bytes`` and ``close(t) -> bytes`` drive a bundle archive's
    writers (None in files mode, where a member writes its own file)."""

    def __init__(self, workers: int, stats: dict, append=None, close=None):
        self.workers = max(1, int(workers))
        self.stats = stats
        self._append = append
        self._close = close
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._heap = []         # (stage, -kept count, seq, record, fn)
        self._seq = itertools.count()
        self._threads = 0
        self._open = {}         # seq -> unresolved record, in submit order
        self._in_flight = 0     # unresolved batch records
        self._in_flight_bytes = 0
        self._largest = 0       # the largest batch's bytes so far
        self._busy = 0.0        # seconds of finished busy intervals
        self._busy_since = 0.0
        self._pumping = False
        self.error = None

    # ---- the caller's side ----

    def submit(self, nbytes: int, out_dir: str, items, size,
               encode) -> cf.Future:
        """Queue a batch of ``len(items)`` members whose coefficients take
        ``nbytes``; -> a Future of its bytes (files: the members' blob
        bytes; bundle: the bytes appended).  For each member ``k``:
        ``size(k) -> (kept count, counters)`` and ``encode(k) -> (blob, or
        its length once written; counters)``, where counters is a dict of
        stats to add."""
        with self._lock:
            rec = _Record(next(self._seq), nbytes, out_dir, list(items))
            if self.error is not None:
                rec.future.set_exception(self.error)
                return rec.future
            if not rec.items:
                rec.future.set_result(0)
                return rec.future
            self._open[rec.seq] = rec
            if not self._in_flight:
                self._busy_since = time.perf_counter()
            self._in_flight += 1
            self._in_flight_bytes += nbytes
            self._largest = max(self._largest, nbytes)
            for k in range(len(rec.items)):
                self._push(0, 0, rec, lambda k=k: self._run_size(
                    rec, k, size, encode))
            self._spawn()
        return rec.future

    def close_later(self, t: int | None = None) -> cf.Future:
        """Close timestep ``t``'s bundles (all: None) once every record
        submitted before has been appended; -> a Future of their bytes
        (files mode: 0, at once)."""
        with self._lock:
            rec = _Record(next(self._seq), close=(t,))
            if self.error is not None:
                rec.future.set_exception(self.error)
                return rec.future
            if self._append is None:
                rec.future.set_result(0)
                return rec.future
            self._open[rec.seq] = rec
        self._pump()
        return rec.future

    def wait_for_room(self, nbytes: int) -> None:
        """Block while the records in flight and ``nbytes`` more would hold
        more than two of the largest batch's coefficient bytes (a batch
        may always start when nothing is in flight); raise the stream's
        failure."""
        with self._lock:
            while (self.error is None and self._in_flight_bytes
                   and self._in_flight_bytes + nbytes
                   > 2 * max(self._largest, nbytes)):
                self._cond.wait()
            if self.error is not None:
                raise self.error

    def quiesce(self) -> None:
        """Block until no record is open and no worker runs; raises
        nothing (the records' Futures carry their failures)."""
        with self._lock:
            while self._open or self._threads or self._pumping:
                self._cond.wait()

    @contextlib.contextmanager
    def overlap(self, sink: dict):
        """Add to ``sink["pack_overlap_seconds"]`` the seconds of the block
        in which records submitted before it were in flight."""
        with self._lock:
            b0 = self._busy_now()
        try:
            yield
        finally:
            with self._lock:
                sink["pack_overlap_seconds"] = (
                    sink.get("pack_overlap_seconds", 0.0)
                    + self._busy_now() - b0)

    # ---- the workers' side ----

    def _busy_now(self) -> float:
        if not self._in_flight:
            return self._busy
        return self._busy + time.perf_counter() - self._busy_since

    def _push(self, stage: int, key: int, rec: _Record, fn) -> None:
        heapq.heappush(self._heap, (stage, key, next(self._seq), rec, fn))

    def _spawn(self) -> None:
        while self._threads < min(self.workers, len(self._heap)):
            self._threads += 1
            # not a daemon: the interpreter joins it at exit, as it joins
            # a ThreadPoolExecutor's workers, instead of ending it inside
            # a native call
            threading.Thread(target=self._work, name="wtc-pack").start()

    def _work(self) -> None:
        while True:
            with self._lock:
                if not self._heap:
                    self._threads -= 1
                    self._cond.notify_all()
                    return
                *_, rec, fn = heapq.heappop(self._heap)
            try:
                fn()
            except BaseException as exc:
                self._fail(rec, exc)

    def _count(self, counters: dict) -> None:
        with self._lock:
            for key, value in counters.items():
                self.stats[key] = self.stats.get(key, 0) + value

    def _run_size(self, rec: _Record, k: int, size, encode) -> None:
        n, counters = size(k)
        self._count(counters)
        with self._lock:
            if not rec.failed:
                self._push(1, -n, rec,
                           lambda: self._run_encode(rec, k, encode))
                self._spawn()

    def _run_encode(self, rec: _Record, k: int, encode) -> None:
        out, counters = encode(k)
        self._count(counters)
        self._fill(rec, k, out)

    def _fill(self, rec: _Record, k: int, out) -> None:
        """Store a finished member's output: in files mode the record
        resolves with its last member; in bundle mode the appender takes
        them in order."""
        with self._lock:
            if rec.failed:
                return
            rec.outs[k] = out
            rec.left -= 1
            if self._append is None:
                if rec.left:
                    return
                done = self._resolve(rec, sum(rec.outs))
        if self._append is None:
            done()
        else:
            self._pump()

    def _resolve(self, rec: _Record, result):
        """Take ``rec`` off the open records (under the lock); -> the call
        that sets its Future, to make outside the lock."""
        del self._open[rec.seq]
        if rec.items is not None:
            self._in_flight -= 1
            self._in_flight_bytes -= rec.nbytes
            if not self._in_flight:
                busy = time.perf_counter() - self._busy_since
                self._busy += busy
                self.stats["pack_seconds"] = (
                    self.stats.get("pack_seconds", 0.0) + busy)
        self._cond.notify_all()
        if isinstance(result, BaseException):
            return lambda: rec.future.set_exception(result)
        return lambda: rec.future.set_result(result)

    def _pump(self) -> None:
        """Bundle mode: append every ready blob and run every due close,
        in record order, on one thread at a time."""
        with self._lock:
            if self._pumping:
                return
            self._pumping = True
        while True:
            with self._lock:
                rec = next(iter(self._open.values()), None)
                if rec is not None and rec.close is None \
                        and rec.next < len(rec.items) \
                        and rec.outs[rec.next] is not _EMPTY:
                    k, blob = rec.next, rec.outs[rec.next]
                    rec.outs[k] = None
                elif rec is not None and rec.close is not None:
                    k = blob = None
                else:
                    self._pumping = False
                    self._cond.notify_all()
                    return
            try:
                n = (self._close(*rec.close) if rec.close is not None
                     else self._append(rec.out_dir, rec.items[k], blob))
            except BaseException as exc:
                with self._lock:
                    self._pumping = False
                self._fail(rec, exc)
                return
            with self._lock:
                if rec.failed:
                    continue
                done = None
                rec.total += n
                rec.next += 1
                if rec.close is not None or rec.next == len(rec.items):
                    done = self._resolve(rec, rec.total)
            if done is not None:
                done()

    def _fail(self, rec: _Record, exc: BaseException) -> None:
        """Fail ``rec`` and every open record submitted after it, drop
        their queued tasks, and keep ``exc`` for every later call."""
        with self._lock:
            if self.error is None:
                self.error = exc
            doomed = [r for r in self._open.values() if r.seq >= rec.seq]
            done = []
            for r in doomed:
                r.failed = True
                done.append(self._resolve(r, exc))
            self._heap = [e for e in self._heap if not e[3].failed]
            heapq.heapify(self._heap)
        for d in done:
            d()
