"""The device trace of a ``--trace 1`` window, reduced to what the metrics
read: device busy time as the union of the device's intervals, time by
device operation, and the longest idle gaps named by what the host was
doing.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Trace:
    window_s: float
    busy_s: float = 0.0
    by_name: dict = field(default_factory=dict)   # device op -> seconds
    gaps: list = field(default_factory=list)      # [(host op, seconds)]
    has_device: bool = False

    def seconds_of(self, kernels) -> float:
        """Device seconds of the operations whose name holds any of
        ``kernels``."""
        return sum(s for name, s in self.by_name.items()
                   if any(k in name for k in kernels))

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in self.gaps[:10]]}


def _union(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events, window_s: float, window_name: str) -> Trace:
    """A :class:`Trace` of the profiler's ``events()``: device intervals
    (microseconds) are those whose ``device_type`` is CUDA, but for the
    device-side copies of the benchmark's own ``record_function`` ranges,
    which mark no work."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    lo = hi = None
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda and (e.name.startswith("wtbench.") or
                                      getattr(e, "is_user_annotation", False)):
            continue
        if e.device_type == cuda:
            dev.append((s, t, e.name))
        else:
            host.append((s, t, e.name))
            if e.name == window_name:
                lo, hi = s, t
    tr = Trace(window_s=window_s, has_device=bool(dev))
    for s, t, name in dev:
        tr.by_name[name] = tr.by_name.get(name, 0.0) + (t - s) / 1e6
    merged = _union([(s, t) for s, t, _ in dev])
    tr.busy_s = sum(t - s for s, t in merged) / 1e6
    if lo is None:
        return tr
    edges = [lo] + [v for m in merged for v in m] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    for length, start in gaps:
        mid = start + length / 2
        inside = [(t - s, n) for s, t, n in host if s <= mid <= t]
        name = min(inside)[1] if inside else "no host op"
        tr.gaps.append((f"host: {name}", length / 1e6))
    return tr


@contextmanager
def traced(enabled: bool, device: str, out: dict, name="wtbench.window"):
    """Profile the body when ``enabled``; ``out["trace"]`` gets the
    :class:`Trace`.  Without it the body runs unprofiled."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if str(device).startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(name):
            t0 = time.perf_counter()
            yield
            if str(device).startswith("cuda"):
                import torch

                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    out["trace"] = reduce(prof.events(), wall, name)
