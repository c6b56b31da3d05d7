"""Phase timing for the pipelines' log lines, and the profiler switch.

:func:`phase_timer` is the port's own copy of the one in
``wavelet_tpu/runtime/debug.py``, so that the port imports nothing of
``wavelet_tpu``; :func:`maybe_profile` is its counterpart on
``torch.profiler`` (CLI ``profile=DIR``).  That module's other helpers set
jax options and have no counterpart here.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

log = logging.getLogger("wavelet_tpu_torch")

__all__ = ["phase_timer", "maybe_profile"]


class _Phase:
    """Mutable handle yielded by :func:`phase_timer`; set ``nbytes`` inside
    the block to get a GB/s figure, read ``seconds`` after it."""

    def __init__(self, nbytes):
        self.nbytes = nbytes
        self.seconds = 0.0


@contextlib.contextmanager
def phase_timer(name: str, nbytes: int | None = None,
                message: str | None = None):
    """Log a phase's wall time (and GB/s when a byte count is given) — the
    TPU build's version of the reference's chrono phase logs (modes.cpp:93,
    107, 170), plus the throughput figure BASELINE.json's metric asks for.

    ``message`` overrides the default "name: N s" wording with a reference-
    parity log line (one ``%s`` placeholder receives the seconds)."""
    ph = _Phase(nbytes)
    t0 = time.perf_counter()
    yield ph
    ph.seconds = time.perf_counter() - t0
    text = (message % ph.seconds) if message else f"{name}: {ph.seconds:.3f} s"
    if ph.nbytes:
        text += " (%.3g GB/s)" % (ph.nbytes / 1e9 / max(ph.seconds, 1e-12))
    log.info("%s", text)


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None):
    """Profile the enclosed region into ``trace_dir`` if set, else no-op:
    a ``torch.profiler`` trace of the CPU and (where there is a card) CUDA
    activities, written as a Chrome trace ``trace_p<rank>.json`` (open it
    in Perfetto or ``chrome://tracing``)."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wavelet_tpu_torch.runtime import mesh as mesh_lib

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir,
                        f"trace_p{mesh_lib.process_index()}.json")
    log.info("Capturing torch.profiler trace to %s", path)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)
