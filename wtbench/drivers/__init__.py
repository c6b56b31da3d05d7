"""Traffic drivers, found by name: a traffic file's ``kind`` names
``drivers/<kind>.py``, and its other keys are that driver's parameters.

A driver module defines

- ``Driver(ctx)``, with ``setup()``, ``window(seconds) -> records`` and
  ``check(records) -> (numbers, failed)``, and the class attribute
  ``produces`` (``"archive"`` or ``"boxes"``), which the end-to-end
  readers go by;
- ``LIMITS``: each number ``check`` returns, with its limit;
- ``control(ds, traffic, seed, device, dtype) -> numbers``: the same
  comparison of the plain reference put in the program's place at
  ``dtype``.

A new way of driving the program, with its comparison, is a new file.  A
pass window closes at the end of the pass that crosses ``--seconds``.
"""

from __future__ import annotations

import importlib.util
import os
import time
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))


def load(kind: str):
    """The driver module of the traffic kind ``kind``."""
    path = os.path.join(HERE, f"{kind}.py")
    spec = importlib.util.spec_from_file_location(
        f"wtbench.drivers.{kind.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Run:
    """What a window did, for the metric readers."""

    produces: str
    records: list = field(default_factory=list)  # one per pass
    setup_s: float = 0.0
    trace: object = None        # trace.Trace of a --trace 1 run
    peak_bw: float | None = None

    def total(self, key: str) -> float:
        return sum(r[key] for r in self.records)

    def stat(self, key: str) -> float:
        return sum(r["stats"].get(key, 0.0) for r in self.records)


def sync(device) -> None:
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


class Base:
    """What the drivers share: the program's compress call over the whole
    dataset, and passes back to back."""

    produces = ""

    def __init__(self, ctx):
        self.ctx = ctx
        self.ds = ctx.dataset
        self.keep = float(ctx.traffic.get("keep", 0.999))

    def compress(self, out_dir, components=None, **extra):
        import wavelet_tpu_torch

        snaps = self.ds.snapshots
        return wavelet_tpu_torch.compress(
            self.ctx.data_dir, out_dir, min_time=snaps[0].name,
            max_time=snaps[-1].name,
            components=list(components or self.ds.components), min_level=0,
            max_level=self.ds.n_levels - 1, keep=self.keep,
            device=self.ctx.device, **extra)

    def passes(self, seconds: float, one_pass) -> list:
        from torch.profiler import record_function

        records = []
        t0 = time.perf_counter()
        while True:
            with record_function(f"wtbench.{self.ctx.traffic['kind']}_pass"):
                records.append(one_pass(len(records)))
            if time.perf_counter() - t0 >= seconds:
                return records
