"""Phase timing for the pipelines' log lines.

The port's own copy of :func:`phase_timer` from
``wavelet_tpu/runtime/debug.py``, so that the port imports nothing of
``wavelet_tpu``; that module's other helpers drive jax and are not copied.
"""

from __future__ import annotations

import contextlib
import logging
import time

log = logging.getLogger("wavelet_tpu_torch")

__all__ = ["phase_timer"]


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
