"""Metric readers: ``metrics/<name>.py`` defines ``read(run)``, which
returns the metric's value or None when the run gives it nothing to read
(the harness then leaves the metric out).  ``run`` is a
:class:`wtbench.drivers.Run`; the helpers below are what the readers share.
"""

from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str):
    """The reader of the metric ``name``."""
    path = os.path.join(HERE, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"wtbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def gbps(run):
    """Float32 box bytes of the window's passes over their wall, GB/s."""
    wall = run.total("wall")
    return run.total("f32_bytes") / wall / 1e9 if wall > 0 else None


def s_per_gb(run, stat: str):
    """Seconds of the pipeline stat ``stat`` per GB of float32 boxes."""
    gb = run.total("f32_bytes") / 1e9
    return run.stat(stat) / gb if gb > 0 else None


def idle_share(run):
    """Percent of the traced window in which no device operation ran."""
    tr = run.trace
    if tr is None or not tr.has_device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline(run, kernels, nbytes: float):
    """Percent of the memory roofline that ``kernels`` reach: ``nbytes``
    at the card's peak bandwidth over their device seconds."""
    tr = run.trace
    if tr is None or run.peak_bw is None:
        return None
    secs = tr.seconds_of(kernels)
    if secs <= 0:
        return None
    return 100.0 * nbytes / run.peak_bw / secs
