"""What the port's host benches share: the device and the card a run is
labelled with, the private directory it works in, and its JSON artifact."""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile

from wavelet_tpu_torch import bench
from wavelet_tpu_torch.runtime.mesh import resolve_device

__all__ = ["device_card", "private_dir", "write_json"]


def device_card(device: str):
    """-> ``(torch.device, card)``: ``card`` is :func:`bench.card`'s name
    and power limit on a CUDA device, ``"cpu"`` on the CPU.  ``cuda``
    without a card raises (there is no CPU fallback)."""
    dev = resolve_device(device)
    return dev, (bench.card() if dev.type == "cuda" else "cpu")


@contextlib.contextmanager
def private_dir(root: str | None, prefix: str):
    """A directory of this run's own, made under ``root`` (None: the
    temporary directory) and removed with everything in it at the end;
    nothing else under ``root`` is touched."""
    d = tempfile.mkdtemp(prefix=prefix, dir=root)
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


def write_json(path: str, obj, indent: int = 2) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=indent, default=float)
