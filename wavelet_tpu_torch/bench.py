"""Device codec throughput on dense AMR blocks, on one card.

    python -m wavelet_tpu_torch.bench [--device cuda|cpu] [--n 128]
        [--dim 64] [--reps 5] [--iters 10] [--e2e PATH]

Prints ONE JSON line::

    {"metric": "device_compress_throughput_per_chip", "value": GB/s,
     "unit": "GB/s", "vs_baseline": value / 10, "extra": {...}}

The port's counterpart of the JAX package's ``bench.py``, with its keys.
Headline: the device compress stage on ``[n, dim^3]`` float32 boxes — the
faster of the two forward routes plus the threshold mask — against the 10
GB/s north star of BASELINE.json, which is an END-TO-END target
(``scripts/bench_e2e.py`` in this package measures that; ``--e2e PATH``
embeds the summary of one of its artifacts under ``extra.e2e``, which is
null otherwise).

Every timed callable is the function the pipelines call: the kernel
wrappers ``haar_cuda.fused_forward``/``fused_inverse`` (the ``halves``
route at ``pack=1``, the default), ``packed_cuda.packed_forward``/
``packed_inverse`` (the lane-packed route, P = ``lane_pack_factor``),
``pyramid_cuda.pyramid_forward``, ``compact_cuda.compact`` and
``CodecEngine.scatter_rows``; the mask is plain torch, as the JAX
package's is jnp outside any kernel.

Methodology (:func:`time_stage`): one warm-up launch; then ``reps`` reps,
each on a FRESH input drawn from a seeded numpy generator (the first
rep's is the warm-up's), put on the device and synchronised before the
clock starts; a rep times ``iters``
back-to-back launches on one stream between two CUDA events
(``time.perf_counter`` on the CPU); the stage's figure is the median rep,
with the min/max spread and the reps used and dropped.  At [128, 64^3]
one input is 128 MiB, over the H100's 50 MB L2, so the kernels read cold
memory as in the pipeline.  Speed-of-light guard: a rep whose implied
traffic (the bytes the stage must move at least: each input read once,
each output written once) exceeds the H100's 3.35e12 B/s of HBM is not a
measurement and is dropped; if every rep is dropped the stage reports that
floor with ``all_reps_implausible: true``.

Without a card, ``--device cuda`` (the default) raises: nothing falls back
to the CPU, and a stage that raises fails the run.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from wavelet_tpu_torch.core import haar, threshold
from wavelet_tpu_torch.kernels import (compact_cuda, haar_cuda, packed_cuda,
                                       pyramid_cuda)
from wavelet_tpu_torch.runtime import engine
from wavelet_tpu_torch.runtime.mesh import resolve_device

__all__ = ["HBM_BYTES_PER_S", "BASELINE_GBPS", "time_stage", "median_rep",
           "launch_timer", "Inputs", "mask", "thresholds", "stages", "card",
           "kernel_launches", "measure", "main"]

# H100 SXM HBM3 (data sheet): no rep may imply more traffic than this
HBM_BYTES_PER_S = 3.35e12
BASELINE_GBPS = 10.0          # BASELINE.json north star, end to end
KEEP = 0.999
COMPACT_THRESHOLD = 2.6       # P(|N(0,1)| > 2.6) ~ 0.93% kept
_KERNEL_MODULES = (haar_cuda, pyramid_cuda, packed_cuda, compact_cuda)


def median_rep(run_rep, make_x, reps: int, nbytes: int,
               traffic_mult: float, hbm: float = HBM_BYTES_PER_S):
    """-> ``(median seconds, spread)`` of ``reps`` calls ``run_rep(make_x())``,
    each returning seconds per launch.  A rep faster than ``nbytes *
    traffic_mult / hbm`` is dropped; if all are, the floor comes back with
    ``all_reps_implausible``.  The spread keys are the JAX bench's."""
    floor_dt = nbytes * traffic_mult / hbm
    times, dropped = [], 0
    for _ in range(reps):
        dt = run_rep(make_x())
        if dt < floor_dt:        # faster than the card can move the bytes
            dropped += 1
            continue
        times.append(dt)
    if not times:
        return floor_dt, {"min_gbps_dt": floor_dt, "max_gbps_dt": floor_dt,
                          "reps_used": 0, "reps_dropped_implausible": dropped,
                          "all_reps_implausible": True}
    return float(np.median(times)), {
        "min_gbps_dt": float(min(times)), "max_gbps_dt": float(max(times)),
        "reps_used": len(times), "reps_dropped_implausible": dropped}


def launch_timer(fn, device: torch.device, iters: int):
    """-> ``run_rep(x)``: seconds per launch of ``fn(x)``, the mean of
    ``iters`` back-to-back launches (CUDA events on the card)."""
    if device.type == "cuda":
        def run_rep(x):
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(x)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / iters
    else:
        def run_rep(x):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(x)
            return (time.perf_counter() - t0) / iters
    return run_rep


def time_stage(fn, make_x, device, reps: int, iters: int, nbytes: int,
               traffic_mult: float = 2.0):
    """Warm up ``fn`` once, then :func:`median_rep` over fresh inputs (the
    first rep reuses the warm-up's: a host input of 128 MiB takes ~0.5 s
    to draw, and a card keeps no cache of past executions)."""
    first = [make_x()]
    fn(first[0])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return median_rep(launch_timer(fn, device, iters),
                      lambda: first.pop() if first else make_x(), reps,
                      nbytes, traffic_mult)


class Inputs:
    """Fresh seeded inputs on the device, each synchronised before it is
    returned; every call draws from the next seed."""

    def __init__(self, device: torch.device, seed: int):
        self.device, self.seed = device, seed

    def _put(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a).to(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return t

    def normal(self, shape):
        def make():
            self.seed += 1
            return self._put(np.random.default_rng(self.seed).standard_normal(
                shape, dtype=np.float32))
        return make

    def pairs(self, n: int, m: int, cap: int):
        """Padded (position, value) rows as ``HostPacker.unpack_sparse``
        hands them to the engine: half the slots real, sorted and distinct,
        the rest distinct padding positions >= m; int32 positions, as
        ``decompress_shapebatch_sparse`` passes them to ``scatter_rows``."""
        def make():
            self.seed += 1
            rr = np.random.default_rng(self.seed)
            idx = np.empty((n, cap), np.int32)
            for i in range(n):
                idx[i, : cap // 2] = np.sort(rr.choice(m, cap // 2,
                                                       replace=False))
            idx[:, cap // 2:] = m + np.arange(cap - cap // 2, dtype=np.int32)
            vals = rr.standard_normal((n, cap)).astype(np.float32)
            return self._put(idx), self._put(vals)
        return make


def mask(c: torch.Tensor, t32: torch.Tensor) -> torch.Tensor:
    """``|c| > t`` per item: ``c [N, X, Y, Z]``, ``t32 [N]`` (the JAX
    bench's jnp mask)."""
    return torch.where(c.abs() > t32.view(-1, 1, 1, 1), c,
                       torch.zeros((), dtype=c.dtype, device=c.device))


def card() -> dict:
    """The card's ``name`` and ``power.limit`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    name, limit = out.strip().splitlines()[0].rsplit(",", 1)
    return {"name": name.strip(), "power.limit": limit.strip()}


def kernel_launches() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    out = {}
    for mod in _KERNEL_MODULES:
        out.update(mod.launches)
    return out


def _stage(gb: float, dt: float, sp: dict) -> dict:
    """Per-stage report: median GB/s, spread and plausibility evidence."""
    d = {"gbps": round(gb / dt, 3),
         "gbps_max": round(gb / sp["min_gbps_dt"], 3),
         "gbps_min": round(gb / sp["max_gbps_dt"], 3),
         "reps_used": sp["reps_used"],
         "reps_dropped_implausible": sp["reps_dropped_implausible"]}
    if sp.get("all_reps_implausible"):
        d["all_reps_implausible"] = True
    return d


def _e2e_summary(path):
    """The summary of the e2e artifact ``path`` (``scripts/bench_e2e.py
    --out``), or None when no path is given."""
    if path is None:
        return None
    with open(path) as f:
        ed = json.load(f)
    pick = ed.get("cube128", ed.get("cube64", {}))
    coll = pick.get("collected", {})
    return {"artifact": path, "semantics": ed.get("semantics"),
            "card": ed.get("card"),
            "e2e_measured_gbps": coll.get("e2e_measured_gbps"),
            "link_share_of_wall": coll.get("link_share_of_wall"),
            "e2e_link_normalized_gbps": coll.get("e2e_link_normalized_gbps"),
            "reconciliation": coll.get("reconciliation")}


def thresholds(x: torch.Tensor, keep: float = KEEP) -> torch.Tensor:
    """Per-item f32 thresholds of boxes ``x`` as the engine derives them:
    the forward kernel's extrema, the first-occurrence tie rule, then
    ``exact_threshold32``."""
    c, maxv, minv = haar_cuda.fused_forward(x)
    flat = c.reshape(c.shape[0], -1).cpu().numpy()
    signed = threshold.resolve_signed_absmax(
        maxv.cpu().numpy(), minv.cpu().numpy(), row_getter=flat.__getitem__)
    return torch.from_numpy(threshold.exact_threshold32(signed, keep)).to(
        x.device)


def stages(dev: torch.device, n: int, d: int, t32: torch.Tensor,
           large_n: int, large_dim: int):
    """-> ``({name: (timed callable, its fresh input, minimum bytes one
    call moves)}, geometry)``: each callable is the function the pipelines
    call.  ``t32`` [n] are the mask's thresholds."""
    shape = (n, d, d, d)
    nbytes = n * d ** 3 * 4
    # the lane-packed route: P boxes per row, P dividing n
    pack = math.gcd(n, packed_cuda.lane_pack_factor((d, d, d)))
    pshape = (n // pack, d, d, pack * d)
    ls = (large_n, large_dim, large_dim, large_dim)
    lbytes = int(np.prod(ls)) * 4
    m = d ** 3
    # the engine's steady-state cap: 1.5x the ~0.93% kept of N(0, 1) rows
    # at t = 2.6, rounded up to 128 slots
    cap = int(np.ceil(1.5 * 0.0093 * m / 128) * 128)
    tc = torch.full((n,), COMPACT_THRESHOLD, dtype=torch.float32, device=dev)
    scap = int(np.ceil(0.02 * m / 128) * 128)
    return {
        "forward": (haar_cuda.fused_forward, shape, 2 * nbytes),
        "forward_packed": (lambda v: packed_cuda.packed_forward(v, pack),
                           pshape, 2 * nbytes),
        "mask": (lambda v: mask(v, t32), shape, 2 * nbytes),
        "inverse": (haar_cuda.fused_inverse, shape, 2 * nbytes),
        "inverse_packed": (lambda v: packed_cuda.packed_inverse(v, pack),
                           pshape, 2 * nbytes),
        # the fused kernel on large boxes against the plain multi-pass
        # torch forward (which moves the box once per pass: 2x is a floor)
        "large_fused": (lambda v: pyramid_cuda.pyramid_forward(v, 1), ls,
                        2 * lbytes),
        "large_plain": (haar.haar3d_forward, ls, 2 * lbytes),
        # the sparse compress stage and its yardstick: the rows read once
        # (the pairs written add ~1%)
        "compact": (lambda v: compact_cuda.compact(v, tc, cap), (n, m),
                    nbytes),
        "nonzero": (lambda v: torch.nonzero(v.abs() > tc[:, None]), (n, m),
                    nbytes),
        # the sparse decompress stage: pairs scattered into zeroed rows,
        # the dense rows written once
        "scatter": (lambda p: engine.CodecEngine.scatter_rows(
            p[0], p[1], (d, d, d)), ("pairs", n, m, scap), nbytes),
    }, {"pack": pack, "cap": cap, "scatter_cap": scap, "large": ls}


def measure(device="cuda", n: int = 128, dim: int = 64, reps: int = 5,
            iters: int = 10, large_n: int = 32, large_dim: int = 128,
            e2e=None) -> dict:
    """Time every stage and run the quality round trip; -> the JSON object
    :func:`main` prints."""
    dev = resolve_device(device)
    d = dim
    launches0 = kernel_launches()
    # the quality inputs, as the JAX bench draws them
    orig = np.random.default_rng(0).standard_normal(
        (n, d, d, d)).astype(np.float32)
    nbytes = orig.nbytes
    gb = nbytes / 1e9
    fns, geo = stages(dev, n, d, thresholds(torch.from_numpy(orig).to(dev)),
                      large_n, large_dim)
    inputs = Inputs(dev, 100)
    dt, sp = {}, {}
    for name, (fn, shape, floor_bytes) in fns.items():
        make = (inputs.pairs(*shape[1:]) if shape[0] == "pairs"
                else inputs.normal(shape))
        dt[name], sp[name] = time_stage(fn, make, dev, reps, iters,
                                        floor_bytes, 1.0)

    def used(name):
        return {k: sp[name][k] for k in ("reps_used",
                                         "reps_dropped_implausible")}

    lgb = int(np.prod(geo["large"])) * 4 / 1e9
    large = {"block_shape": list(geo["large"]),
             "fused_gbps": round(lgb / dt["large_fused"], 3),
             "fused_spread": used("large_fused"),
             "plain_gbps": round(lgb / dt["large_plain"], 3),
             "plain_spread": used("large_plain"),
             "fused_vs_plain": round(dt["large_plain"] / dt["large_fused"],
                                     3)}
    m = d ** 3
    compact = {"gbps": round(gb / dt["compact"], 3),
               "ms": dt["compact"] * 1e3,
               "nonzero_gbps": round(gb / dt["nonzero"], 3),
               "nonzero_ms": dt["nonzero"] * 1e3,
               "vs_nonzero": round(dt["nonzero"] / dt["compact"], 3),
               "cap": geo["cap"], "cap_fraction": geo["cap"] / m,
               "threshold": COMPACT_THRESHOLD, **used("compact")}
    scatter = {"gbps_dense_rebuilt": round(gb / dt["scatter"], 3),
               "ms": dt["scatter"] * 1e3, "cap": geo["scatter_cap"],
               "cap_fraction": geo["scatter_cap"] / m, **used("scatter")}
    for name, row in (("large_fused", large), ("large_plain", large),
                      ("compact", compact), ("scatter", scatter)):
        if sp[name].get("all_reps_implausible"):
            row["all_reps_implausible"] = True

    best_fwd, layout = min((dt["forward"], "halves"),
                           (dt["forward_packed"], "packed"))
    best_inv, inv_layout = min((dt["inverse"], "halves"),
                               (dt["inverse_packed"], "packed"))
    compress_gbps = gb / (best_fwd + dt["mask"])

    # quality on a real (non-chained) round trip through the engine
    eng = engine.CodecEngine(device=dev)
    flat, kept = eng.compress_batch(orig, KEEP)
    recon = eng.decompress_batch(np.where(kept, flat, 0.0), (d, d, d))
    rmse = float(np.sqrt(np.mean(
        (recon.astype(np.float64) - orig.astype(np.float64)) ** 2)))

    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    info = card() if dev.type == "cuda" else {"name": None,
                                               "power.limit": None}
    return {
        "metric": "device_compress_throughput_per_chip",
        "value": round(compress_gbps, 3),
        "unit": "GB/s",
        "vs_baseline": round(compress_gbps / BASELINE_GBPS, 3),
        "extra": {
            "vs_baseline_note": ("baseline 10 GB/s is an END-TO-END target; "
                                 "this headline is the device stage alone "
                                 "(forward + mask) — e2e rows come from "
                                 "scripts/bench_e2e.py"),
            "e2e": _e2e_summary(e2e),
            "large_box_128": large,
            "sparse_compact_stage": compact,
            "sparse_scatter_stage": scatter,
            "platform": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
            **info,
            "block_shape": [n, d, d, d],
            "bytes": nbytes,
            "methodology": (
                f"median of {reps} fresh-input reps of {iters} launches "
                "each (CUDA events on the card); reps implying more than "
                "3.35e12 B/s of traffic (H100 HBM3) are dropped"),
            "headline_layout": layout,
            "decompress_layout": inv_layout,
            "forward": _stage(gb, dt["forward"], sp["forward"]),
            "forward_packed": {**_stage(gb, dt["forward_packed"],
                                        sp["forward_packed"]),
                               "pack": geo["pack"]},
            "mask": _stage(gb, dt["mask"], sp["mask"]),
            "inverse": _stage(gb, dt["inverse"], sp["inverse"]),
            "inverse_packed": {**_stage(gb, dt["inverse_packed"],
                                        sp["inverse_packed"]),
                               "pack": geo["pack"]},
            "decompress_gbps": round(gb / best_inv, 3),
            "roundtrip_gbps": round(gb / (best_fwd + dt["mask"] + best_inv),
                                    3),
            # the pipelines run the halves route at pack=1 by default, and
            # threshold during the host pack: their device stage is that
            # forward alone
            "pipeline_device_stage_gbps": round(gb / dt["forward"], 3),
            "keep": KEEP,
            "kept_coeff_fraction": round(float(kept.mean()), 6),
            "roundtrip_rmse": rmse,
            "launches": launches,
        },
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m wavelet_tpu_torch.bench",
        description="Device codec throughput of wavelet_tpu_torch (one "
                    "JSON line).")
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--n", type=int, default=128, help="boxes per batch")
    ap.add_argument("--dim", type=int, default=64, help="box edge")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10,
                    help="launches per timed rep")
    ap.add_argument("--large-n", type=int, default=32)
    ap.add_argument("--large-dim", type=int, default=128)
    ap.add_argument("--e2e", default=None, metavar="PATH",
                    help="a scripts/bench_e2e.py artifact to summarise "
                         "under extra.e2e (default: none)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    a = parse_args(argv)
    print(json.dumps(measure(a.device, a.n, a.dim, a.reps, a.iters,
                             a.large_n, a.large_dim, a.e2e)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
