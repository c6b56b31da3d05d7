"""Exact stream compaction of thresholded rows for Hopper: wrapper, plain
version and launch count.

:func:`compact` ``flat [n, m] f32, t32 [n] f32, cap -> (counts [n] int32,
idx [n, cap] int32, vals [n, cap] f32)``: row i keeps the positions p with
``|flat[i, p]| > t32[i]``; slot j < ``min(counts[i], cap)`` holds the j-th
kept position in ascending order and its value.  Slots past that are junk
that no consumer reads.  It is ``engine._compact_step`` of the JAX
package, and replaces its sort-free drop-in
``wavelet_tpu/kernels/compact_pallas.py:compact_fast`` — the TPU kernels
``_rank_select_pallas`` (K8), ``_rank_select_pallas_direct`` (K10) and
``_assemble_pallas`` (K9) — with one single-pass kernel, ``compact``
(CUDA C++, ``wavelet_tpu_torch/csrc/compact.cu``): each tile of a row is
read once, ranked in the block, and its row offset found by a decoupled
look-back over the row's earlier tiles, so each kept pair is written at
its final slot in the one launch.

The result is exact for every row: no per-chunk capacity, no overflow flag,
no argsort fallback.  A CUDA tensor launches the kernel or raises; a CPU
tensor goes to :func:`compact_plain` (the whole-row branch of
``_compact_step``), which is also what the kernel is held to on the card.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from wavelet_tpu_torch.kernels.haar_cuda import _raise_if, _stream

__all__ = ["compact", "compact_plain", "launches", "reset_launches"]

launches = {"compact": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def compact_plain(flat: torch.Tensor, t32: torch.Tensor, cap: int):
    """Plain PyTorch: the mask, its row counts, and the first ``cap`` kept
    positions by a stable argsort of the inverted mask (kept first, each
    group in position order), with their values."""
    mask = flat.abs() > t32[:, None]
    counts = mask.sum(dim=1, dtype=torch.int32)
    order = torch.argsort(~mask, dim=1, stable=True)[:, :cap]
    return counts, order.to(torch.int32), torch.gather(flat, 1, order)


def _check(flat: torch.Tensor, t32: torch.Tensor, cap: int) -> None:
    if flat.dtype != torch.float32 or t32.dtype != torch.float32:
        raise TypeError(f"compact: expected float32 flat and t32, got "
                        f"{flat.dtype} and {t32.dtype}")
    if flat.dim() != 2 or min(flat.shape) <= 0:
        raise ValueError(f"compact: expected a non-empty [n, m] flat, got "
                         f"shape {tuple(flat.shape)}")
    n, m = (int(d) for d in flat.shape)
    if tuple(t32.shape) != (n,):
        raise ValueError(f"compact: t32 shape {tuple(t32.shape)} != ({n},)")
    if m >= 2**31:
        raise ValueError(f"compact: row length {m} needs int64 positions")
    if not 0 < cap <= m:
        raise ValueError(f"compact: cap={cap} outside 1..{m}")
    if flat.device != t32.device:
        raise ValueError(f"compact: flat on {flat.device}, t32 on "
                         f"{t32.device}")
    if flat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"compact: unsupported device {flat.device}")
    if not (flat.is_contiguous() and t32.is_contiguous()):
        raise ValueError("compact: expected contiguous tensors")


def compact(flat: torch.Tensor, t32: torch.Tensor, cap: int):
    """``flat [n, m]`` f32, ``t32 [n]`` f32 -> ``(counts [n] int32,
    idx [n, cap] int32, vals [n, cap] f32)``."""
    cap = int(cap)
    _check(flat, t32, cap)
    if flat.device.type == "cpu":
        return compact_plain(flat, t32, cap)
    from wavelet_tpu_torch.kernels import build

    lib = build.library()
    n, m = (int(d) for d in flat.shape)
    words = int(lib.wt_compact_scratch(n, m))
    if words < 0:
        raise ValueError(f"compact: [{n}, {m}] needs more tiles than one "
                         "launch takes")
    dev = flat.device
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    idx = torch.empty((n, cap), dtype=torch.int32, device=dev)
    vals = torch.empty((n, cap), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        # the tiles' status words and the ticket: zeroed for this call
        # alone (never cached: concurrent calls on other streams would race)
        scratch = torch.zeros(words, dtype=torch.int64, device=dev)
        err = lib.wt_compact(flat.data_ptr(), t32.data_ptr(),
                             counts.data_ptr(), idx.data_ptr(),
                             vals.data_ptr(), scratch.data_ptr(), n, m, cap,
                             _stream(flat))
        _raise_if(err, lib, "compact")
        launches["compact"] += 1
    return counts, idx, vals
