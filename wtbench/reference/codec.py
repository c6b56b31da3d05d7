"""The codec's semantics in plain PyTorch operations: the reference that the
program's archives and regenerated boxes are judged by.

It follows the reference C++ tool's definition, not the program's code:

- forward 3D Haar: along Z, then Y, then X, each line's pairs ``(a, b)``
  map to ``(a + b) * 0.5`` in the first half and ``(a - b) * 0.5`` in the
  second, each rounded once (an odd tail passes through);
- inverse: along X, then Y, then Z, ``(avg + diff, avg - diff)`` (an odd
  tail is zeroed);
- threshold per (box, field): the signed coefficient of largest magnitude
  (the first in C order on ties) times ``1 - keep`` in double; a
  coefficient is kept when its magnitude, in double, is above it;
- a member's payload: int32 ``x, y, z, x*y*z, pairs``, then per kept
  coefficient in C order the int32 count of zeros before it and its
  float32 value.

Every function takes tensors on any device and a ``dtype``: float32 is the
reference, a lower precision is the control.  Nothing here imports the
program.
"""

from __future__ import annotations

import struct

import numpy as np
import torch


def _fwd_last(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    h = n // 2
    a, b = x[..., 0:2 * h:2], x[..., 1:2 * h:2]
    parts = [(a + b) * 0.5, (a - b) * 0.5]
    if n % 2:
        parts.append(x[..., 2 * h:])
    return torch.cat(parts, dim=-1)


def _inv_last(c: torch.Tensor) -> torch.Tensor:
    n = c.shape[-1]
    h = n // 2
    avg, diff = c[..., :h], c[..., h:2 * h]
    out = torch.stack([avg + diff, avg - diff], dim=-1).flatten(-2)
    if n % 2:
        out = torch.cat([out, torch.zeros_like(c[..., :1])], dim=-1)
    return out


def _along(fn, x: torch.Tensor, axis: int) -> torch.Tensor:
    return fn(x.movedim(axis, -1)).movedim(-1, axis)


def forward(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``[..., X, Y, Z]`` boxes -> their coefficients, as float32."""
    x = x.to(dtype)
    for axis in (-1, -2, -3):
        x = _along(_fwd_last, x, axis)
    return x.to(torch.float32).contiguous()


def inverse(c: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    c = c.to(dtype)
    for axis in (-3, -2, -1):
        c = _along(_inv_last, c, axis)
    return c.to(torch.float32).contiguous()


def thresholds(c: torch.Tensor, keep: float) -> torch.Tensor:
    """Per row of ``c`` ``[N, M]``: the float64 threshold."""
    mag = c.abs()
    top = mag.amax(dim=1, keepdim=True)
    pos = torch.arange(c.shape[1], device=c.device).expand_as(c)
    # a NaN counts as the largest magnitude, the first one winning
    hit = torch.where(torch.isnan(top), torch.isnan(mag), mag == top)
    first = torch.where(hit, pos, c.shape[1]).amin(dim=1)
    signed = c.gather(1, first[:, None])[:, 0].double()
    return signed * (1.0 - float(keep))


def kept_mask(c: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    return c.abs().double() > thr[:, None]


def kept_counts(boxes: torch.Tensor, keep: float,
                dtype=torch.float32) -> torch.Tensor:
    """Kept coefficients of each box of ``boxes`` ``[N, X, Y, Z]``."""
    c = forward(boxes, dtype).reshape(boxes.shape[0], -1)
    return kept_mask(c, thresholds(c, keep)).sum(dim=1)


def regenerate(boxes: torch.Tensor, keep: float,
               dtype=torch.float32) -> torch.Tensor:
    """What decompression regenerates of ``boxes`` ``[N, X, Y, Z]``."""
    c = forward(boxes, dtype).reshape(boxes.shape[0], -1)
    kept = torch.where(kept_mask(c, thresholds(c, keep)), c,
                       torch.zeros_like(c))
    return inverse(kept.reshape(boxes.shape), dtype)


def payloads(boxes: torch.Tensor, keep: float,
             dtype=torch.float32) -> list:
    """The member payload of each box of ``boxes`` ``[N, X, Y, Z]``."""
    n, x, y, z = (int(d) for d in boxes.shape)
    c = forward(boxes, dtype).reshape(n, -1)
    mask = kept_mask(c, thresholds(c, keep)).cpu().numpy()
    vals = c.cpu().numpy()
    out = []
    for i in range(n):
        idx = np.flatnonzero(mask[i])
        pairs = np.empty(len(idx), dtype=[("run", "<i4"), ("val", "<f4")])
        pairs["run"] = np.diff(idx, prepend=np.int64(-1)) - 1
        pairs["val"] = vals[i, idx]
        out.append(struct.pack("<5i", x, y, z, x * y * z, len(idx))
                   + pairs.tobytes())
    return out
