"""The global threshold mode in plain PyTorch: the reference that the
``compress_global`` driver's archives are judged by.

The rule, as the mode's users set it (``thresholdmode=global
keepfraction=F scales=S``): keep about the fraction F of every coefficient
of the run, the largest by magnitude, under one magnitude threshold for
every (box, field).  Written from that rule and the archive's format:

- the pyramid: the forward Haar of ``codec.forward`` on the box, then,
  for each further scale s, the same forward on the low corner ``[:X >> s,
  :Y >> s, :Z >> s]`` of what the last scale wrote, in place;
- the histogram: each float32 coefficient's key ``(bits & 0x7FFFFFFF) >>
  20`` (the magnitude's 8 exponent bits and top 3 mantissa bits, which
  order magnitudes), counted in 2048 bins over every coefficient;
- the bin rule: with ``target = F * total``, the threshold belongs to the
  smallest bin k whose count of coefficients strictly above the
  threshold, those of the bins k and up, is at most the target; where
  that leaves nothing (the target falls inside the top populated bin, or
  no bin qualifies), k steps down to the last populated bin; the
  threshold is the float32 just below bin k's lower edge, bits ``(k <<
  20) - 1``, so that ``|c| > threshold`` keeps bins k and up exactly;
- a member: ``codec.payloads``'s bytes, a coefficient kept when its
  float32 magnitude is above the threshold.

Departures from the rule's plain reading, each the mode's own:

- the threshold sits on a bin edge, so the mode keeps at most F, not F
  exactly: the kept share lands anywhere in the bin the target falls in;
- the step-down keeps more than F where the target falls inside the top
  populated bin, so a run of one constant value keeps every nonzero;
- at k <= 1 (bins of subnormal magnitudes) the threshold is 0.0: every
  nonzero coefficient is kept;
- only the coefficients this node's ranks hold are counted: the
  configuration's absent nodes are left out of the sum, in the program and
  here alike.

Every function takes tensors on any device and a ``dtype``: float32 is
the reference, a lower precision is the control.  Nothing here imports the
program.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from wtbench.reference import codec

BINS = 2048
SHIFT = 20


def pyramid(x: torch.Tensor, scales: int, dtype=torch.float32) -> torch.Tensor:
    """``[..., X, Y, Z]`` boxes -> their ``scales``-deep pyramids, float32."""
    c = codec.forward(x, dtype)
    X, Y, Z = c.shape[-3:]
    for s in range(1, scales):
        cx, cy, cz = X >> s, Y >> s, Z >> s
        c[..., :cx, :cy, :cz] = codec.forward(c[..., :cx, :cy, :cz], dtype)
    return c


def histogram(c: torch.Tensor) -> torch.Tensor:
    """int64 counts of the 2048 magnitude keys of float32 ``c``."""
    key = (c.contiguous().reshape(-1).view(torch.int32) & 0x7FFFFFFF) >> SHIFT
    return torch.bincount(key, minlength=BINS).to(torch.int64)


def bin_threshold(hist, keep_fraction: float) -> np.float32:
    """The bin rule above: the magnitude threshold of ``hist``."""
    h = torch.as_tensor(np.asarray(hist), dtype=torch.int64).cpu()
    target = float(keep_fraction) * int(h.sum())
    # above[k]: coefficients in bins k and up
    above = torch.flip(torch.cumsum(torch.flip(h, [0]), 0), [0])
    fits = torch.nonzero(above <= target).flatten()
    k = int(fits[0]) if len(fits) else BINS
    populated = torch.nonzero(h).flatten()
    last = int(populated[-1]) if len(populated) else -1
    k = min(k, last)
    if k <= 1:
        return np.float32(0.0)
    return np.uint32((k << SHIFT) - 1).view(np.float32)


def members(c: torch.Tensor, thr: np.float32) -> list:
    """The member payload of each pyramid of ``c`` ``[N, X, Y, Z]`` at the
    one threshold ``thr``."""
    n, x, y, z = (int(d) for d in c.shape)
    flat = c.reshape(n, -1).cpu().numpy()
    out = []
    for row in flat:
        idx = np.flatnonzero(np.abs(row) > thr)
        pairs = np.empty(len(idx), dtype=[("run", "<i4"), ("val", "<f4")])
        pairs["run"] = np.diff(idx, prepend=np.int64(-1)) - 1
        pairs["val"] = row[idx]
        out.append(struct.pack("<5i", x, y, z, x * y * z, len(idx))
                   + pairs.tobytes())
    return out


def _chunks(ds, chunk_bytes: int):
    """``(keys [(t, lev, b)], boxes (n, C, X, Y, Z) host f32)`` of every
    box, one shape at a time, at most ``chunk_bytes`` a chunk."""
    groups = {}
    for t, s in enumerate(ds.snapshots):
        for lev, boxes in enumerate(s.boxes):
            for b, arr in enumerate(boxes):
                groups.setdefault(arr.shape, []).append((t, lev, b))
    for shape, keys in groups.items():
        step = max(1, chunk_bytes // (int(np.prod(shape)) * 4))
        for i in range(0, len(keys), step):
            part = keys[i:i + step]
            yield part, np.stack([ds.snapshots[t].boxes[lev][b]
                                  for t, lev, b in part])


def reference(ds, keep_fraction: float, scales: int, device,
              dtype=torch.float32, chunk_bytes: int = 1 << 28):
    """-> (the threshold, ``(t, lev, comp, box) -> payload bytes`` of every
    item of ``ds``): the histogram over every item first, then the
    members at its threshold."""
    def pyramids():
        for part, host in _chunks(ds, chunk_bytes):
            x = torch.from_numpy(host).to(device)
            yield part, pyramid(x.reshape(-1, *x.shape[2:]), scales, dtype)

    hist = torch.zeros(BINS, dtype=torch.int64)
    for _part, c in pyramids():
        hist += histogram(c).cpu()
    thr = bin_threshold(hist, keep_fraction)
    out = {}
    ncomp = len(ds.components)
    for part, c in pyramids():
        got = iter(members(c, thr))
        for t, lev, b in part:
            for comp in range(ncomp):
                out[(t, lev, comp, b)] = next(got)
    return thr, out
