"""Spans over the program's stages, the pipelines' phase log lines, and the
profiler switch.

:func:`span` times one stage of the program: it adds its wall seconds (and,
where asked, its thread's CPU seconds) to a stats dict, and, while a
``torch.profiler`` is recording, opens a profiler range of the same name,
so that a trace names the host's stages on the same clock as the CUDA
activity.  With no profiler running a span is two clock reads, a push and
a pop of this thread's span stack and a dict addition: 1.3-1.5 us on the
8-core host of an H100, 7-9 us with ``cpu=True``, where ``thread_time`` is
a system call.  The stages are the ones the pipelines' stats report:

- calling thread: ``compress.setup``, ``compress.run``, ``compress.read``,
  ``compress.device_step``, ``compress.pack_wait``, ``compress.close``;
  ``decompress.run``, ``decompress.unpack``, ``decompress.device_step``,
  ``decompress.assemble``, ``decompress.write``; inside a device step
  ``engine.h2d``, ``engine.launch``, ``engine.d2h``, ``engine.threshold``,
  ``engine.free``; ``kernels.build``;
- the pack thread: ``pack.batch``; the packer's worker threads:
  ``pack.member``, ``pack.xz``, ``unpack.member``, ``unpack.xz``.  A
  worker's span adds to no shared dict: its member returns the seconds and
  the caller sums them.

:func:`phase_timer` is a span that also logs the reference's phase lines
(``wavelet_tpu/runtime/debug.py`` has the JAX package's copy; the port
imports nothing of ``wavelet_tpu``).  :func:`maybe_profile` is the CLI's
``profile=DIR``.  That module's other helpers set jax options and have no
counterpart here.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

log = logging.getLogger("wavelet_tpu_torch")

__all__ = ["span", "phase_timer", "maybe_profile"]

_local = threading.local()


def _profiling() -> bool:
    # process-wide: a profiler that records every thread is on here too,
    # where the per-thread torch._C._autograd._profiler_enabled() reads
    # False in pool threads
    return _autograd_profiler._is_profiler_enabled


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class span:
    """``with span(name, sink, key, cpu=False, args=()) as s:`` — one
    stage of the program.

    On exit ``s.seconds`` holds its wall seconds (``perf_counter``) and,
    with ``cpu=True``, ``s.cpu_seconds`` its thread's CPU seconds
    (``thread_time``); both are added to ``sink`` (a stats dict), under
    ``key`` and under ``key`` with ``_seconds`` replaced by
    ``_cpu_seconds``, when a sink is given.  ``s.parent`` names the span of
    this thread that contains it.  While a profiler runs the span is a
    profiler range named ``name`` (``RecordFunctionFast``, the C++ range
    ``torch.profiler.record_function`` also opens) whose inputs are
    ``args``, integers (the batch's shape and item count, say), so that
    range names stay few; the profiler nests it in its parent's range."""

    __slots__ = ("name", "sink", "key", "cpu", "args", "parent", "seconds",
                 "cpu_seconds", "_t0", "_c0", "_range")

    def __init__(self, name: str, sink: dict | None = None,
                 key: str | None = None, cpu: bool = False, args=()):
        self.name = name
        self.sink = sink
        self.key = key
        self.cpu = cpu
        self.args = args
        self.parent = None
        self.seconds = 0.0
        self.cpu_seconds = 0.0
        self._range = None

    def __enter__(self) -> "span":
        # the clocks start before the range opens and stop after it
        # closes: a span's seconds hold its own profiler cost, so that
        # under a profiler a parent's time is covered by its children
        self._t0 = time.perf_counter()
        self._c0 = time.thread_time() if self.cpu else 0.0
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        if _profiling():
            # the C++ range, not torch.profiler.record_function, which
            # opens and closes it through two operator calls: ~2 us a
            # range against ~16 us (8-core host, profiler on)
            self._range = torch._C._profiler._RecordFunctionFast(
                self.name, [int(v) for v in self.args])
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _stack().pop()
        if self.cpu:
            self.cpu_seconds = time.thread_time() - self._c0
        self.seconds = time.perf_counter() - self._t0
        sink = self.sink
        if sink is not None:
            sink[self.key] = sink.get(self.key, 0.0) + self.seconds
            if self.cpu:
                key = self.key.replace("_seconds", "_cpu_seconds")
                sink[key] = sink.get(key, 0.0) + self.cpu_seconds


class _Phase:
    """Mutable handle yielded by :func:`phase_timer`; set ``nbytes`` inside
    the block to get a GB/s figure, read ``seconds`` after it."""

    def __init__(self, nbytes):
        self.nbytes = nbytes
        self.seconds = 0.0


@contextlib.contextmanager
def phase_timer(name: str, nbytes: int | None = None,
                message: str | None = None, sink: dict | None = None,
                key: str | None = None):
    """Log a phase's wall time (and GB/s when a byte count is given) — the
    TPU build's version of the reference's chrono phase logs (modes.cpp:93,
    107, 170), plus the throughput figure BASELINE.json's metric asks for.
    The phase is the :func:`span` ``name``, adding its seconds to
    ``sink[key]`` when a sink is given.

    ``message`` overrides the default "name: N s" wording with a reference-
    parity log line (one ``%s`` placeholder receives the seconds)."""
    ph = _Phase(nbytes)
    with span(name, sink, key) as sp:
        yield ph
    ph.seconds = sp.seconds
    text = (message % ph.seconds) if message else f"{name}: {ph.seconds:.3f} s"
    if ph.nbytes:
        text += " (%.3g GB/s)" % (ph.nbytes / 1e9 / max(ph.seconds, 1e-12))
    log.info("%s", text)


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None):
    """Profile the enclosed region into ``trace_dir`` if set, else no-op:
    a ``torch.profiler`` trace of the CPU and (where there is a card) CUDA
    activities on every thread, so that the packer's worker spans show
    beside the calling thread's, written as a Chrome trace
    ``trace_p<rank>.json`` (open it in Perfetto or ``chrome://tracing``)."""
    if not trace_dir:
        yield
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    from wavelet_tpu_torch.runtime import mesh as mesh_lib

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir,
                        f"trace_p{mesh_lib.process_index()}.json")
    log.info("Capturing torch.profiler trace to %s", path)
    with profile(activities=acts, experimental_config=_ExperimentalConfig(
            profile_all_threads=True)) as prof:
        yield
    prof.export_chrome_trace(path)
