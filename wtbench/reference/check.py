"""The comparisons that decide ``correct``: each returns numbers, every one
held to the limit that its driver's ``LIMITS`` gives it.

The codec's guarantee is exact (the configuration files state it), so
every number counts outputs that differ from the reference in a single
bit, and every limit is 0.  The outputs come in through callables, so the
same comparison judges the program's outputs and the control's.
"""

from __future__ import annotations

import concurrent.futures as cf

import numpy as np
import torch

from wtbench.reference import codec

def _groups(ds):
    """Boxes grouped by shape: ``shape -> [(t, lev, b)]``."""
    out = {}
    for t, s in enumerate(ds.snapshots):
        for lev, boxes in enumerate(s.boxes):
            for b, arr in enumerate(boxes):
                out.setdefault(arr.shape[1:], []).append((t, lev, b))
    return out


def reference_payloads(ds, keep: float, device, dtype=torch.float32,
                       chunk_bytes: int = 1 << 28) -> dict:
    """``(t, lev, comp, box) -> payload bytes`` of every item."""
    out = {}
    ncomp = len(ds.components)
    for dims, keys in _groups(ds).items():
        step = max(1, chunk_bytes // (int(np.prod(dims)) * 4 * ncomp))
        for i in range(0, len(keys), step):
            part = keys[i:i + step]
            host = np.stack([ds.snapshots[t].boxes[lev][b]
                             for t, lev, b in part])
            x = torch.from_numpy(host).to(device).reshape(-1, *dims)
            got = iter(codec.payloads(x, keep, dtype))
            for t, lev, b in part:
                for c in range(ncomp):
                    out[(t, lev, c, b)] = next(got)
    return out


def compare_compress(ds, keep: float, passes: list, present, payload_of,
                     device, workers: int = 8):
    """Every member of every pass against the reference.  ``present(p)``:
    the member keys of pass p; ``payload_of(p, key)``: that member's
    payload bytes (a member that cannot be read counts as wrong).  ->
    (numbers, the passes at fault)."""
    expected = set(ds.items())
    ref = reference_payloads(ds, keep, device)

    def ok(job):
        p, key = job
        try:
            return payload_of(p, key) == ref[key]
        except (ValueError, OSError, EOFError, LookupError):
            return False

    missing = wrong = 0
    bad = set()
    with cf.ThreadPoolExecutor(workers) as pool:
        for p in passes:
            have = set(present(p))
            miss = len(expected - have) + len(have - expected)
            jobs = [(p, k) for k in sorted(expected & have)]
            n_wrong = sum(not v for v in pool.map(ok, jobs))
            missing += miss
            wrong += n_wrong
            if miss or n_wrong:
                bad.add(p)
    return {"missing_members": missing, "wrong_members": wrong}, bad


def _differs(a: np.ndarray, b: torch.Tensor) -> bool:
    a = torch.from_numpy(np.ascontiguousarray(a)).to(b.device)
    if a.shape != b.shape:
        return True
    return bool(((a != b) & ~(torch.isnan(a) & torch.isnan(b))).any())


def compare_regen(ds, keep: float, held: list, device,
                  dtype=torch.float32) -> list:
    """``held``: ``((t, lev, b), array (C, X, Y, Z))`` regenerated boxes;
    -> for each, whether it differs from the reference."""
    return [_differs(arr, codec.regenerate(
        torch.from_numpy(ds.snapshots[t].boxes[lev][b]).to(device), keep,
        dtype)) for (t, lev, b), arr in held]


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number within its limit, and a limit for every number."""
    return set(numbers) == set(limits) and \
        all(v <= limits[k] for k, v in numbers.items())
