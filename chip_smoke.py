#!/usr/bin/env python3
"""End-to-end smoke check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # one card

Phases (any failure exits non-zero before the last line):

1. ``torch.cuda.is_available()`` must hold: there is no CPU fallback.
2. Print the card's name and power limit (nvidia-smi).
3. Build the CUDA kernels from ``wavelet_tpu_torch/csrc`` with nvcc.
4. Each kernel against its plain PyTorch version on the card, bitwise
   (int32 views) on coefficients, per-box max and min, and exactly equal
   histograms: the paths' shapes at 1, 2 and 3 scales, odd shapes,
   subnormals, an exact ``min == -max`` tie, a box holding NaN, +-inf and
   signed zeros; then each inverse on the same shapes.  One exception: a
   zero extremum may come back as +0.0 from one and -0.0 from the other.
   The sign of a zero extremum cannot change ``|c| > t32`` (the threshold
   is then +-0 and no magnitude is below zero), so it cannot change an
   archive byte.  The compaction (``compact_count`` + ``compact_scatter``)
   against its plain version, counts and the first ``count`` pairs
   bitwise: rows of 1 to 64^3 elements with NaN, +-inf, signed zeros,
   subnormals and thresholds negative, -0, +inf and NaN, and the main
   path's [160, 262144] coefficient rows at the dataset's kept fraction.
   The lane-packed kernels (``packed_forward``, ``packed_inverse``,
   ``packed_forward_hist``) likewise, bitwise with histograms exactly:
   [80, 64, 64, 128] (P = 2, the dataset's 64^3 boxes), [*, 32, 64, 128]
   (P = 2), [*, 8, 4, 128] (P = 64), odd X/Y (5, 3, 16) at P = 8,
   subnormals, +-inf, NaN and a ``min == -max`` tie box.
5. End to end: a synthetic AMR run (2 timesteps, 2 levels, 4 components,
   ~168 MiB of f32 boxes per timestep, f64 FABs on disk) compressed and
   decompressed with ``device=cuda`` through the pipelines the CLI calls
   (``cli.parse_argv`` then ``compress_run`` / ``decompress_run``, which
   return the per-stage seconds), in three configurations: (a) the main
   path (box thresholds, keep=0.999, one scale), (b) ``scales=2`` on the
   first timestep only (to keep the script's time down; one timestep
   holds every box shape), (c) ``thresholdmode=global keepfraction=0.02
   scales=2``, (d) (b) with ``transfer=sparse`` on ``-c`` and ``-d``, (e)
   (a) under ``WAVELET_TPU_LAYOUT=halves`` (the lane-packed route) on the
   first timestep.  Each archive and each set of regenerated
   plotfiles must be byte-identical to the same run with ``device=cpu``
   (the plain path, which the CPU tests hold bitwise to the JAX package),
   each path's kernels must have been launched in its run (the counts are
   set to 0 just before and read just after), and the output must be
   finite and close to the input.  (d)'s archive and plotfiles must also
   be (b)'s, with fewer bytes over the link both ways; (e)'s payloads and
   plotfiles must be (a)'s, with the packed kernels launched on every
   bucket and the unpacked ones never; and (c)'s archive decompressed with
   ``transfer=sparse`` must give (c)'s plotfiles.  (f), ``-c`` on the first
   timestep under ``WAVELET_TPU_LAYOUT=halves``: ``thresholdmode=global
   keepfraction=0.02 transfer=sparse`` must write the default layout's
   archive through ``packed_forward_hist``, and ``keep=0.999
   transfer=sparse`` (e)'s archive through ``packed_forward`` and the
   compaction.  (g) ``-estimate`` on timestep 0, level 0: the scratch path
   (keep=0.999), ``fastestimate=1 keep="0.99 0.999 0.9999"`` and
   ``thresholdmode=global keepfraction="0.01 0.02"``, each with
   ``device=cuda`` and ``device=cpu`` at both layouts, must report the
   same RMSE, adjusted loss and size; ``devicemetrics=1`` must agree with
   the host metrics to ``rtol=1e-5``.  Then ``-check`` and ``-info`` on
   (a)'s archive.
6. Timing: kernel and plain-version times with CUDA events at the main
   path's 64^3 batch (the compaction on its coefficient rows; the packed
   kernels on the same boxes packed two to a row, and at P = 64 beside
   K1/K2 on the same bytes of 8x4x2 boxes), each kernel's bound (its
   inputs read once and outputs written once at 3.35 TB/s), the link
   rate, and the two sparse-transfer stage rates that set
   ``transfer=auto``'s breakevens.

The line before the last is the JSON kernel report; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")

COMPONENTS = ["density", "temp", "pressure", "x_velocity"]
TIMESTEPS = ["plt00100", "plt00200"]
KEEP = 0.999
CHECK_SHAPES = [(32, 64, 64, 64), (4, 32, 64, 64), (3, 33, 17, 9),
                (2, 1, 1, 1), (5, 8, 4, 2)]
TIME_SHAPE = (160, 64, 64, 64)   # the main path's 64^3 bucket per timestep
PACKED_SHAPE = (80, 64, 64, 128)   # the same boxes lane-packed, P = 2
P64_SHAPE = (10240, 8, 4, 128)     # 8x4x2 boxes at P = 64, the same bytes
TIME_SCALES = 2
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory, data sheet
# (name, extra -c keys, extra -d keys, timesteps, kernels the path must
# launch, bound on the reconstruction error, the configuration whose
# device=cuda archive and plotfiles this one must equal, options: "env"
# set around both runs, "payloads_of" a configuration whose payload files
# and plotfiles of these timesteps this one must equal, "per_bucket"
# kernels launched at least once per shape bucket of each direction,
# "never" kernels that must not run).  The bound is
# "range" = max |x - x'| / the box's range, or "threshold" = max |x - x'|
# / the global threshold, which is at most 7 * scales + 1: each point sums
# one coefficient per band of its cell at every scale, and each dropped one
# is at most the threshold.
PYRAMID_PATH = ("haar_forward", "haar_inverse", "pyramid_forward",
                "pyramid_inverse")
HALVES = {"WAVELET_TPU_LAYOUT": "halves"}   # the lane-packed kernel route
CONFIGS = [
    ("a", [f"keep={KEEP}"], [], TIMESTEPS, ("haar_forward", "haar_inverse"),
     ("range", 0.01), None),
    ("b", [f"keep={KEEP}", "scales=2"], [], TIMESTEPS[:1], PYRAMID_PATH,
     ("range", 0.02), None),
    ("c", ["thresholdmode=global", "keepfraction=0.02", "scales=2"], [],
     TIMESTEPS, ("forward_hist", "haar_inverse", "pyramid_inverse"),
     ("threshold", 7 * 2 + 1), None),
    ("d", [f"keep={KEEP}", "scales=2", "transfer=sparse"],
     ["transfer=sparse"], TIMESTEPS[:1],
     PYRAMID_PATH + ("compact_count", "compact_scatter"), ("range", 0.02),
     "b"),
    ("e", [f"keep={KEEP}"], [], TIMESTEPS[:1],
     ("packed_forward", "packed_inverse"), ("range", 0.01), None,
     {"env": HALVES, "payloads_of": "a",
      "per_bucket": ("packed_forward", "packed_inverse"),
      "never": ("haar_forward", "haar_inverse")}),
]
# TPU kernel(s) each port kernel replaces, and its source in the port (the
# single-scale kernels are the pyramid kernels at scales=1)
KERNELS = {
    "haar_forward": ("wavelet_tpu/kernels/haar_pallas.py:172",
                     "wavelet_tpu_torch/csrc/pyramid.cu"),
    "haar_inverse": ("wavelet_tpu/kernels/haar_pallas.py:202",
                     "wavelet_tpu_torch/csrc/pyramid.cu"),
    "pyramid_forward": ("wavelet_tpu/kernels/haar_pallas.py:527",
                        "wavelet_tpu_torch/csrc/pyramid.cu"),
    "forward_hist": ("wavelet_tpu/kernels/haar_pallas.py:581",
                     "wavelet_tpu_torch/csrc/pyramid.cu"),
    "pyramid_inverse": ("wavelet_tpu/kernels/haar_pallas.py:643",
                        "wavelet_tpu_torch/csrc/pyramid.cu"),
    "compact_count": ("wavelet_tpu/kernels/compact_pallas.py:196 (K8) and "
                      "wavelet_tpu/kernels/compact_pallas.py:344 (K10)",
                      "wavelet_tpu_torch/csrc/compact.cu"),
    "compact_scatter": ("wavelet_tpu/kernels/compact_pallas.py:484 (K9)",
                        "wavelet_tpu_torch/csrc/compact.cu"),
    "packed_forward": ("wavelet_tpu/kernels/haar_pallas.py:242 (K3)",
                       "wavelet_tpu_torch/csrc/packed.cu"),
    "packed_inverse": ("wavelet_tpu/kernels/haar_pallas.py:288 (K4)",
                       "wavelet_tpu_torch/csrc/packed.cu"),
    "packed_forward_hist": ("wavelet_tpu/kernels/haar_pallas.py:242 (K3, "
                            "the packed global pass with the histogram)",
                            "wavelet_tpu_torch/csrc/packed.cu"),
}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _bits_equal(a, b, zero_sign_ok=False) -> bool:
    import torch

    eq = a.view(torch.int32) == b.view(torch.int32)
    if zero_sign_ok:
        eq = eq | ((a == 0) & (b == 0))
    return bool(eq.all())


def _max_abs_err(a, b) -> float:
    import torch

    both = torch.isfinite(a) & torch.isfinite(b)
    if not bool(both.any()):
        return 0.0
    return float((a[both].double() - b[both].double()).abs().max())


def _check_inputs(device):
    """(name, tensor) cases for phase 4, made from numpy seeds."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    cases = []
    for shape in CHECK_SHAPES:
        x = (rng.standard_normal(shape) * 50).astype(np.float32)
        cases.append((f"normal{list(shape)}", x))
    for shape in ((3, 33, 17, 9), (5, 8, 4, 2)):
        x = (rng.standard_normal(shape) * 1e-37).astype(np.float32)
        flat = x.reshape(-1)
        flat[::3] = (rng.standard_normal(flat[::3].size) * 1e-42).astype(
            np.float32)
        cases.append((f"subnormal{list(shape)}", x))
    # exact tie: one nonzero at x=1 gives coefficients +1 and -1 only
    tie = np.zeros((5, 8, 4, 2), np.float32)
    tie[:, 1, 0, 0] = 8.0
    cases.append(("tie[5,8,4,2]", tie))
    nan = (rng.standard_normal((3, 33, 17, 9))).astype(np.float32)
    nan[1, 5, 3, 2] = np.array([0x7FFFFFFF], np.uint32).view(np.float32)[0]
    cases.append(("nan[3,33,17,9]", nan))
    zeros = np.zeros((2, 4, 4, 4), np.float32)
    zeros[1, 0, 0, 1] = -0.0
    cases.append(("zeros[2,4,4,4]", zeros))
    return [(n, torch.from_numpy(x).to(device)) for n, x in cases]


def phase_kernels(device) -> dict:
    """Phase 4: kernel vs plain version on the card.  Returns the largest
    absolute error per kernel (0.0 when bitwise equal)."""
    import torch

    from wavelet_tpu_torch.kernels import haar_cuda
    from wavelet_tpu_torch.runtime import engine

    err = {"haar_forward": 0.0, "haar_inverse": 0.0}
    for name, x in _check_inputs(device):
        c, mx, mn = haar_cuda.fused_forward(x)
        pc, pmx, pmn = haar_cuda.fused_forward_plain(x)
        torch.cuda.synchronize()
        ok = (_bits_equal(c, pc) and _bits_equal(mx, pmx, True)
              and _bits_equal(mn, pmn, True))
        err["haar_forward"] = max(err["haar_forward"], _max_abs_err(c, pc),
                                  _max_abs_err(mx, pmx),
                                  _max_abs_err(mn, pmn))
        print(f"  forward {name}: bitwise={ok}")
        if not ok:
            raise AssertionError(f"forward kernel != plain on {name}")
        if name.startswith("tie"):
            flat = c.cpu().numpy().reshape(c.shape[0], -1)
            signed = engine.resolve_signed_absmax(
                mx.cpu().numpy(), mn.cpu().numpy(),
                row_getter=flat.__getitem__)
            first = flat[:, abs(flat[0]).argmax()]
            assert (signed == first).all() and (signed == 1.0).all(), signed
        # the inverse on the kernel's coefficients and on raw values
        # (random coefficients exercise the zeroed odd tails too)
        for what, coeffs in (("coeffs", c), ("raw", x)):
            out = haar_cuda.fused_inverse(coeffs)
            pout = haar_cuda.fused_inverse_plain(coeffs)
            torch.cuda.synchronize()
            ok = _bits_equal(out, pout)
            err["haar_inverse"] = max(err["haar_inverse"],
                                      _max_abs_err(out, pout))
            print(f"  inverse {name} ({what}): bitwise={ok}")
            if not ok:
                raise AssertionError(f"inverse kernel != plain on {name}")
    return err


def _pyramid_inputs(device):
    """(name, tensor, scales) cases for the pyramid kernels."""
    import numpy as np
    import torch

    rng = np.random.default_rng(2)

    def normal(shape):
        return (rng.standard_normal(shape) * 50).astype(np.float32)

    cases = [(f"normal{list(sh)}", normal(sh), s)
             for sh in ((8, 64, 64, 64), (4, 32, 64, 64)) for s in (2, 3)]
    cases.append(("normal[6,8,8,8]", normal((6, 8, 8, 8)), 3))
    sub = (rng.standard_normal((4, 16, 8, 8)) * 1e-37).astype(np.float32)
    flat = sub.reshape(-1)
    flat[::3] = (rng.standard_normal(flat[::3].size) * 1e-42).astype(
        np.float32)
    cases.append(("subnormal[4,16,8,8]", sub, 2))
    # exact tie: one nonzero at x=1 gives scale-0 details +1 and -1 and
    # deeper coefficients 0.125
    tie = np.zeros((5, 8, 4, 4), np.float32)
    tie[:, 1, 0, 0] = 8.0
    cases.append(("tie[5,8,4,4]", tie, 2))
    special = normal((4, 16, 8, 8))
    special[0, 5, 3, 2] = np.array([0x7FFFFFFF], np.uint32).view(
        np.float32)[0]
    special[1, 2, 2, 2] = np.array([0xFFC00000], np.uint32).view(
        np.float32)[0]
    special[2, 0, 0, 0] = np.inf
    special[2, 9, 4, 5] = -np.inf
    special[3] = 0.0
    special[3, 1, 1, 1] = -0.0
    special[3, 4, 0, 6] = -0.0
    cases.append(("nan_inf_zeros[4,16,8,8]", special, 2))
    return [(n, torch.from_numpy(x).to(device), s) for n, x, s in cases]


def phase_pyramid_kernels(device) -> dict:
    """Phase 4, pyramid kernels: each against its plain version on the
    card; returns the largest absolute error per kernel (0.0 when bitwise
    equal; for forward_hist the larger of the coefficients' error and the
    histograms' count difference)."""
    import numpy as np
    import torch

    from wavelet_tpu_torch.kernels import pyramid_cuda
    from wavelet_tpu_torch.runtime import engine

    err = dict.fromkeys(("pyramid_forward", "forward_hist",
                         "pyramid_inverse"), 0.0)

    def check(kernel, name, ok, e):
        err[kernel] = max(err[kernel], e)
        print(f"  {kernel} {name}: bitwise={ok}")
        if not ok:
            raise AssertionError(f"{kernel} kernel != plain on {name}")

    cases = _pyramid_inputs(device)
    # forward_hist at one scale, where it takes odd shapes
    rng = np.random.default_rng(3)
    odd = [(f"normal{list(sh)}",
            torch.from_numpy((rng.standard_normal(sh) * 50).astype(
                np.float32)).to(device), 1)
           for sh in ((3, 33, 17, 9), (5, 8, 4, 2), (2, 1, 1, 1))]
    for name, x, s in cases + odd:
        name = f"{name} s={s}"
        c, hist = pyramid_cuda.forward_hist(x, s)
        pc, phist = pyramid_cuda.forward_hist_plain(x, s)
        torch.cuda.synchronize()
        ok = _bits_equal(c, pc) and bool((hist == phist).all())
        check("forward_hist", name, ok,
              max(_max_abs_err(c, pc),
                  float((hist - phist).abs().max())))
        if s == 1:
            continue
        c, mx, mn = pyramid_cuda.pyramid_forward(x, s)
        pc, pmx, pmn = pyramid_cuda.pyramid_forward_plain(x, s)
        torch.cuda.synchronize()
        ok = (_bits_equal(c, pc) and _bits_equal(mx, pmx, True)
              and _bits_equal(mn, pmn, True))
        check("pyramid_forward", name, ok,
              max(_max_abs_err(c, pc), _max_abs_err(mx, pmx),
                  _max_abs_err(mn, pmn)))
        if name.startswith("tie"):
            flat = c.cpu().numpy().reshape(c.shape[0], -1)
            signed = engine.resolve_signed_absmax(
                mx.cpu().numpy(), mn.cpu().numpy(),
                row_getter=flat.__getitem__)
            first = flat[:, abs(flat[0]).argmax()]
            assert (signed == first).all() and (abs(signed) == 1.0).all(), \
                signed
        for what, coeffs in (("coeffs", c), ("raw", x)):
            out = pyramid_cuda.pyramid_inverse(coeffs, s)
            pout = pyramid_cuda.pyramid_inverse_plain(coeffs, s)
            torch.cuda.synchronize()
            check("pyramid_inverse", f"{name} ({what})",
                  _bits_equal(out, pout), _max_abs_err(out, pout))
    return err


def _compact_edge_cases(device):
    """(name, flat, t32, cap) cases for the compaction, from numpy seeds:
    each row set holds a ~1% row, a row past the cap, NaN and +-inf,
    zeros and signed zeros under thresholds -1 and -0, subnormals under a
    subnormal threshold, and thresholds +inf and NaN."""
    import numpy as np
    import torch

    cases = []
    for m, cap in ((1, 1), (16, 8), (64, 64), (4096, 300), (13824, 517),
                   (3 * 33 * 17 * 9, 2000), (64 ** 3, 5248)):
        rng = np.random.default_rng(m)
        flat = rng.standard_normal((9, m)).astype(np.float32)
        flat[rng.random((9, m)) < 0.01] *= 100
        t32 = np.full(9, 5.0, np.float32)
        flat[1, rng.random(m) < 0.1] = 50.0
        flat[2, rng.random(m) < 0.01] = np.nan
        flat[2, rng.random(m) < 0.01] = np.inf
        flat[2, rng.random(m) < 0.01] = -np.inf
        flat[3, ::2] = 0.0
        flat[3, 1::4] = -0.0
        t32[3] = -1.0
        flat[4, ::3] = -0.0
        t32[4] = -0.0
        flat[5] = (rng.standard_normal(m) * 1e-40).astype(np.float32)
        t32[5] = np.float32(1e-41)
        t32[6] = np.inf
        t32[7] = np.nan
        flat[8] = 0.0
        t32[8] = 0.0
        cases.append((f"edge[9,{m}] cap={cap}",
                      torch.from_numpy(flat).to(device),
                      torch.from_numpy(t32).to(device), cap))
    return cases


def engine_cap(counts, m: int) -> int:
    """The pair capacity the engine adapts to after one batch of these
    counts (``compress_shapebatch_sparse``: 1.5x the largest kept
    fraction, rounded up to 128 slots)."""
    frac = min(0.25, max(float(counts.max()) / m * 1.5, 64 / m))
    return int(min(m, max(128, -(-int(m * frac) // 128) * 128)))


def main_path_rows(data_dir: str, device):
    """The main path's compaction input: timestep 0's 160 boxes of 64^3
    (4 components), one-scale coefficients on the card as flat [160,
    262144], the keep=0.999 thresholds, and the engine's adapted cap."""
    import numpy as np
    import torch

    from wavelet_tpu_torch.core import threshold
    from wavelet_tpu_torch.io import plotfile
    from wavelet_tpu_torch.kernels import haar_cuda
    from wavelet_tpu_torch.runtime import engine

    boxes = []
    for lev in (0, 1):
        lv = plotfile.read_level(os.path.join(data_dir, TIMESTEPS[0]), lev,
                                 range(len(COMPONENTS)))
        boxes += [c for b in lv.boxes if b.shape[1:] == TIME_SHAPE[1:]
                  for c in b]
    x = torch.from_numpy(np.stack(boxes).astype(np.float32)).to(device)
    assert tuple(x.shape) == TIME_SHAPE, x.shape
    c, mx, mn = haar_cuda.fused_forward_plain(x)
    flat = c.reshape(c.shape[0], -1)
    signed = engine.resolve_signed_absmax(
        mx.cpu().numpy(), mn.cpu().numpy(),
        row_getter=lambda i: flat[i].cpu().numpy())
    t32 = torch.from_numpy(threshold.exact_threshold32(signed, KEEP)).to(
        device)
    counts = (flat.abs() > t32[:, None]).sum(dim=1).cpu().numpy()
    return flat, t32, engine_cap(counts, flat.shape[1]), counts


def phase_compact_kernels(cases) -> dict:
    """Phase 4, compaction: kernels vs plain version on the card, counts
    and the first min(count, cap) pairs bitwise; returns the largest
    absolute error per kernel (0.0 when bitwise equal)."""
    import torch

    from wavelet_tpu_torch.kernels import compact_cuda

    err = {"compact_count": 0.0, "compact_scatter": 0.0}
    for name, flat, t32, cap in cases:
        counts, idx, vals = compact_cuda.compact(flat, t32, cap)
        pcounts, pidx, pvals = compact_cuda.compact_plain(flat, t32, cap)
        torch.cuda.synchronize()
        ok_count = bool((counts == pcounts).all())
        err["compact_count"] = max(
            err["compact_count"],
            float((counts.long() - pcounts.long()).abs().max()))
        # the slots a consumer reads: j < min(count, cap) of each row
        keep = (torch.arange(cap, device=flat.device)[None, :]
                < pcounts.clamp(max=cap)[:, None])
        ok_pairs = ok_count and (bool((idx[keep] == pidx[keep]).all())
                                 and _bits_equal(vals[keep], pvals[keep]))
        if ok_count and bool(keep.any()):
            err["compact_scatter"] = max(
                err["compact_scatter"],
                float((idx[keep].long() - pidx[keep].long()).abs().max()),
                _max_abs_err(vals[keep], pvals[keep]))
        kept = int(pcounts.sum())
        print(f"  compact {name}: kept {kept} of {flat.numel()}, counts "
              f"bitwise={ok_count}, pairs bitwise={ok_pairs}")
        if not (ok_count and ok_pairs):
            raise AssertionError(f"compaction kernels != plain on {name}")
    return err


def _packed_inputs(device):
    """(name, packed tensor, P) cases for the lane-packed kernels, from
    numpy seeds: boxes of the shape packed P to a row."""
    import numpy as np
    import torch

    rng = np.random.default_rng(4)

    def pack(boxes, p):
        n, x, y, z = boxes.shape
        return np.ascontiguousarray(
            boxes.reshape(n // p, p, x, y, z).transpose(0, 2, 3, 1, 4)
            .reshape(n // p, x, y, p * z))

    def normal(n, dims):
        return (rng.standard_normal((n,) + dims) * 50).astype(np.float32)

    cases = [(f"normal{list(PACKED_SHAPE)} P=2", normal(160, (64, 64, 64)),
              None, 2)]
    cases += [(f"normal[*,{x},{y},{z}] P={p}", normal(n, (x, y, z)), None, p)
              for n, (x, y, z), p in ((6, (32, 64, 64), 2),
                                      (128, (8, 4, 2), 64),
                                      (16, (5, 3, 16), 8))]
    sub = (rng.standard_normal((16, 5, 3, 16)) * 1e-37).astype(np.float32)
    flat = sub.reshape(-1)
    flat[::3] = (rng.standard_normal(flat[::3].size) * 1e-42).astype(
        np.float32)
    cases.append(("subnormal[*,5,3,16] P=8", sub, None, 8))
    special = normal(16, (5, 3, 16))
    special[0, 2, 1, 7] = np.array([0x7FFFFFFF], np.uint32).view(
        np.float32)[0]
    special[1, 4, 2, 3] = np.array([0xFFC00000], np.uint32).view(
        np.float32)[0]
    special[2, 0, 0, 0] = np.inf
    special[2, 3, 1, 9] = -np.inf
    special[3] = 0.0
    special[3, 1, 1, 1] = -0.0
    cases.append(("nan_inf_zeros[*,5,3,16] P=8", special, None, 8))
    # exact tie: one nonzero at x=1 gives coefficients +1 and -1 only
    tie = np.zeros((64, 8, 4, 2), np.float32)
    tie[:, 1, 0, 0] = 8.0
    cases.append(("tie[*,8,4,2] P=64", tie, "tie", 64))
    return [(n, torch.from_numpy(pack(b, p)).to(device), kind, p)
            for n, b, kind, p in cases]


def phase_packed_kernels(device) -> dict:
    """Phase 4, lane-packed kernels: each against its plain version on the
    card; returns the largest absolute error per kernel (0.0 when bitwise
    equal; for packed_forward_hist the larger of the coefficients' error
    and the histograms' count difference)."""
    import torch

    from wavelet_tpu_torch.kernels import packed_cuda
    from wavelet_tpu_torch.runtime import engine

    err = dict.fromkeys(("packed_forward", "packed_inverse",
                         "packed_forward_hist"), 0.0)

    def check(kernel, name, ok, e):
        err[kernel] = max(err[kernel], e)
        print(f"  {kernel} {name}: bitwise={ok}")
        if not ok:
            raise AssertionError(f"{kernel} kernel != plain on {name}")

    for name, x, kind, p in _packed_inputs(device):
        c, mx, mn = packed_cuda.packed_forward(x, p)
        pc, pmx, pmn = packed_cuda.packed_forward_plain(x, p)
        torch.cuda.synchronize()
        check("packed_forward", name,
              _bits_equal(c, pc) and _bits_equal(mx, pmx, True)
              and _bits_equal(mn, pmn, True),
              max(_max_abs_err(c, pc), _max_abs_err(mx, pmx),
                  _max_abs_err(mn, pmn)))
        if kind == "tie":
            rows = packed_cuda.unpack(c, p).reshape(mx.shape[0], -1)
            rows = rows.cpu().numpy()
            signed = engine.resolve_signed_absmax(
                mx.cpu().numpy(), mn.cpu().numpy(),
                row_getter=rows.__getitem__)
            first = rows[:, abs(rows[0]).argmax()]
            assert (signed == first).all() and (signed == 1.0).all(), signed
        hc, hist = packed_cuda.packed_forward_hist(x, p)
        phc, phist = packed_cuda.packed_forward_hist_plain(x, p)
        torch.cuda.synchronize()
        check("packed_forward_hist", name,
              _bits_equal(hc, phc) and bool((hist == phist).all()),
              max(_max_abs_err(hc, phc),
                  float((hist - phist).abs().max())))
        for what, coeffs in (("coeffs", c), ("raw", x)):
            out = packed_cuda.packed_inverse(coeffs, p)
            pout = packed_cuda.packed_inverse_plain(coeffs, p)
            torch.cuda.synchronize()
            check("packed_inverse", f"{name} ({what})",
                  _bits_equal(out, pout), _max_abs_err(out, pout))
    return err


def _field(shape, origin, scale, t, q, rng):
    """One component of a synthetic AMR field on a box: smooth background,
    a tanh shock front moving with t, and small noise (float32)."""
    import numpy as np

    x, y, z = (((np.arange(n) + o) * scale)[(slice(None),) + (None,) * (2 - a)]
               for a, (n, o) in enumerate(zip(shape, origin)))
    front = np.tanh((x + 0.5 * y + 0.25 * z - (0.35 + 0.2 * t)) * 40.0)
    smooth = (np.sin(6.0 * x + q) * np.cos(4.0 * y) * np.sin(3.0 * z + t)
              ) * 0.1
    base = (1.0 + q) * (1.5 + front) + smooth
    out = base + 1e-4 * (1.0 + q) * rng.standard_normal(shape)
    return out.astype(np.float32)


def make_dataset(data_dir: str, seed: int = 0, g: int = 64) -> int:
    """Write the synthetic plotfiles (``g`` = max_grid_size); returns the
    f32 box bytes of the run."""
    import numpy as np

    from wavelet_tpu_torch.io import plotfile

    rng = np.random.default_rng(seed)
    # level 0: 4g x 2g x 2g (256x128x128) in 16 boxes of g^3
    l0 = [((g * i, g * j, g * k), (g, g, g))
          for i in range(4) for j in range(2) for k in range(2)]
    # level 1 (ratio 2): 24 boxes of g^3, 4 of (g/2) x g x g, and one
    # 8x4x2 box like the reference fixture's small one
    l1 = [((g * i, g * j, g * k), (g, g, g))
          for i in range(6) for j in range(2) for k in range(2)]
    l1 += [((6 * g + g // 2 * i, 0, 0), (g // 2, g, g)) for i in range(4)]
    l1 += [((6 * g, g, 0), (8, 4, 2))]
    levels = [(l0, 1.0 / (4 * g)), (l1, 1.0 / (8 * g))]
    nbytes = 0
    for t, name in enumerate(TIMESTEPS):
        boxes = []
        for lev, scale in levels:
            per = []
            for loc, dims in lev:
                per.append(np.stack([_field(dims, loc, scale, t, q, rng)
                                     for q in range(len(COMPONENTS))]))
                nbytes += per[-1].nbytes
            boxes.append(per)
        plotfile.write_plotfile(
            os.path.join(data_dir, name), boxes,
            [[loc for loc, _ in lev] for lev, _ in levels],
            [[dims for _, dims in lev] for lev, _ in levels],
            COMPONENTS, 0.001 * (t + 1), [0.0, 0.0, 0.0], [1.0, 0.5, 0.5],
            (2, 2, 2), (4 * g, 2 * g, 2 * g), [100 * (t + 1), 200 * (t + 1)])
    return nbytes


def _run_cli(args):
    """One ``-c`` or ``-d`` run, as ``cli.main`` makes it: -> (wall
    seconds, the pipeline's stats)."""
    from wavelet_tpu_torch import cli
    from wavelet_tpu_torch.pipeline.compress import compress_run
    from wavelet_tpu_torch.pipeline.decompress import decompress_run

    mode, cfg = cli.parse_argv(args)
    t0 = time.perf_counter()
    stats = (compress_run if mode == "c" else decompress_run)(cfg)
    return time.perf_counter() - t0, stats


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            p = os.path.join(dirpath, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _kernel_modules():
    from wavelet_tpu_torch.kernels import (compact_cuda, haar_cuda,
                                           packed_cuda, pyramid_cuda)

    return haar_cuda, pyramid_cuda, compact_cuda, packed_cuda


def _reset_launches() -> None:
    for mod in _kernel_modules():
        mod.reset_launches()


def _launches() -> dict:
    out = {}
    for mod in _kernel_modules():
        out.update(mod.launches)
    return out


def _env(values: dict):
    """Set environment variables for a block, then restore them."""
    from unittest import mock

    return mock.patch.dict(os.environ, values)


def _n_buckets(data_dir: str, steps) -> int:
    """Shape buckets of these timesteps (one batch each on this dataset)."""
    from wavelet_tpu_torch.io import plotfile

    return sum(len({tuple(d) for lev in (0, 1) for d in
                    plotfile.read_level_meta(os.path.join(data_dir, ts),
                                             lev)[1]})
               for ts in steps)


def _check_counts(name: str, launches: dict, at_least: dict,
                  never=()) -> None:
    for k, n in at_least.items():
        if launches[k] < n:
            raise AssertionError(f"({name}) kernel {k} launched "
                                 f"{launches[k]} times, expected >= {n} "
                                 f"({launches})")
    for k in never:
        if launches[k]:
            raise AssertionError(f"({name}) kernel {k} launched "
                                 f"{launches[k]} times off its path")


def run_config(data_dir: str, nbytes: int, name: str, keys, d_keys, steps,
               expect, bound, same_as, done: dict, opts=None) -> dict:
    """Phase 5 for one configuration: -c/-d on cuda and cpu over the
    timesteps ``steps``, byte-compared, and against the cuda run of
    ``same_as`` (in ``done``, the results so far) when given; ``opts`` as
    in ``CONFIGS``.  Returns timings, the cuda run's per-stage seconds,
    link bytes and launch counts, and the checks' numbers."""
    opts = opts or {}
    nbytes = nbytes * len(steps) // len(TIMESTEPS)
    res = {"timesteps": len(steps), "input_bytes": nbytes}
    stats = {}
    with _env(opts.get("env", {})):
        _run_both(data_dir, name, keys, d_keys, steps, res, stats)
    _check_counts(name, res["launches"], dict.fromkeys(expect, 1))
    n_buckets = _n_buckets(data_dir, steps)
    _check_counts(name, res["launches"],
                  dict.fromkeys(opts.get("per_bucket", ()), n_buckets),
                  opts.get("never", ()))
    return _finish_config(data_dir, name, steps, bound, same_as, done, opts,
                          res, stats, nbytes)


def _run_both(data_dir, name, keys, d_keys, steps, res, stats) -> None:
    """-c then -d with device=cuda, then device=cpu; the cuda run's launch
    counts and pipeline stats go to ``res`` and ``stats``."""
    for dev in ("cuda", "cpu"):
        comp = os.path.join(WORK, f"{name}_arch_{dev}") + os.sep
        out = os.path.join(WORK, f"{name}_out_{dev}") + os.sep
        c_args = [f"datadir={data_dir}", f"minfile={steps[0]}",
                  f"maxfile={steps[-1]}", "minlevel=0", "maxlevel=1",
                  "components=" + " ".join(COMPONENTS), *keys,
                  f"compresseddir={comp}", f"device={dev}", "-c"]
        d_args = [f"compresseddir={comp}", f"out={out}", *d_keys,
                  f"device={dev}", "-d"]
        if dev == "cuda":
            _reset_launches()
        res[f"{dev}_compress_s"], cs = _run_cli(c_args)
        res[f"{dev}_decompress_s"], ds = _run_cli(d_args)
        if dev == "cuda":
            res["launches"] = _launches()
            stats["c"], stats["d"] = cs, ds


def _finish_config(data_dir, name, steps, bound, same_as, done, opts, res,
                   stats, nbytes) -> dict:
    import numpy as np

    from wavelet_tpu_torch import native
    from wavelet_tpu_torch.io import plotfile

    archives = [_tree(os.path.join(WORK, f"{name}_arch_{d}"))
                for d in ("cuda", "cpu")]
    if archives[0] != archives[1]:
        raise AssertionError(f"({name}) archives differ between "
                             "device=cuda and cpu")
    trees = [_tree(os.path.join(WORK, f"{name}_out_{d}"))
             for d in ("cuda", "cpu")]
    if trees[0] != trees[1] or not trees[0]:
        raise AssertionError(f"({name}) plotfiles differ between "
                             "device=cuda and cpu")
    cs, ds = stats["c"], stats["d"]
    res["device_to_host_bytes"] = cs["device_to_host_bytes"]
    res["host_to_device_bytes"] = ds["host_to_device_bytes"]
    if same_as is not None:
        ref = done[same_as]
        if (archives[0] != _tree(os.path.join(WORK, f"{same_as}_arch_cuda"))
                or trees[0] != _tree(os.path.join(WORK,
                                                  f"{same_as}_out_cuda"))):
            raise AssertionError(f"({name}) archive or plotfiles differ "
                                 f"from ({same_as})'s")
        for k in ("device_to_host_bytes", "host_to_device_bytes"):
            if not 0 < res[k] < ref[k]:
                raise AssertionError(f"({name}) {k} {res[k]} not below "
                                     f"({same_as})'s {ref[k]}")
    if "payloads_of" in opts:
        ref = opts["payloads_of"]
        ref_arch = _tree(os.path.join(WORK, f"{ref}_arch_cuda"))
        ref_out = _tree(os.path.join(WORK, f"{ref}_out_cuda"))
        payloads = [k for k in archives[0] if k.endswith(".xz")]
        if (not payloads
                or any(archives[0][k] != ref_arch.get(k) for k in payloads)
                or any(trees[0][k] != ref_out.get(k) for k in trees[0])):
            raise AssertionError(f"({name}) payloads or plotfiles differ "
                                 f"from ({ref})'s")
        res[f"payloads_equal_to_{ref}"] = len(payloads)
    res["archive_bytes"] = sum(len(b) for b in archives[0].values())
    res["plotfile_files"] = len(trees[0])
    res["native_codec"] = bool(native.available())
    res["stages"] = {
        "compress": {k: cs[k] for k in ("compress_seconds", "read_seconds",
                                        "device_seconds",
                                        "pack_wait_seconds")},
        "decompress": {k: ds[k] for k in ("decompress_seconds",
                                          "unpack_seconds", "device_seconds",
                                          "write_seconds")}}
    if "global_threshold" in cs:
        res["global_threshold"] = cs["global_threshold"]
        res["global_cached_timesteps"] = cs["global_cached_timesteps"]
    # the output is the input up to the lossy threshold: finite, same
    # geometry, an error within the configuration's bound
    kind, limit = bound
    worst = 0.0
    for ts in steps:
        for lev in (0, 1):
            a = plotfile.read_level(os.path.join(data_dir, ts), lev,
                                    range(len(COMPONENTS)))
            b = plotfile.read_level(os.path.join(WORK, f"{name}_out_cuda",
                                                 ts), lev,
                                    range(len(COMPONENTS)))
            assert a.dimensions == b.dimensions
            for xa, xb in zip(a.boxes, b.boxes):
                assert np.isfinite(xb).all() and xa.shape == xb.shape
                if kind == "range":
                    scale = float(xa.max() - xa.min()) or 1.0
                else:
                    scale = res["global_threshold"] or 1.0
                worst = max(worst, float(np.abs(xa - xb).max()) / scale)
    if not worst <= limit:
        raise AssertionError(f"({name}) reconstruction error {worst} of "
                             f"the {kind} exceeds {limit}")
    res[f"max_err_per_{kind}"] = worst
    res["gbps"] = {k: nbytes / 1e9 / res[f"{k}_s"]
                   for k in ("cuda_compress", "cuda_decompress",
                             "cpu_compress", "cpu_decompress")}
    return res


def _compress_cuda(data_dir: str, name: str, keys, steps, env=None):
    """One ``-c`` with device=cuda: -> (wall s, stats, launches, archive
    tree)."""
    comp = os.path.join(WORK, f"{name}_arch_cuda") + os.sep
    with _env(env or {}):
        _reset_launches()
        secs, stats = _run_cli([
            f"datadir={data_dir}", f"minfile={steps[0]}",
            f"maxfile={steps[-1]}", "minlevel=0", "maxlevel=1",
            "components=" + " ".join(COMPONENTS), *keys,
            f"compresseddir={comp}", "device=cuda", "-c"])
        launches = _launches()
    return secs, stats, launches, _tree(comp)


def run_packed_compress(data_dir: str) -> dict:
    """(f): ``-c`` under the halves route on the first timestep.  Global
    thresholds (pass 1 through ``packed_forward_hist``; pass 2 packs dense
    coefficients, as in the JAX package, so ``transfer=sparse`` changes
    nothing there) must write the default layout's archive; box thresholds
    with ``transfer=sparse`` (``packed_forward`` then the compaction) must
    write (e)'s archive."""
    steps = TIMESTEPS[:1]
    n = _n_buckets(data_dir, steps)
    keys = ["thresholdmode=global", "keepfraction=0.02", "transfer=sparse"]
    _, _, ref_l, ref = _compress_cuda(data_dir, "f_default", keys, steps)
    _check_counts("f, default layout", ref_l, {"forward_hist": n},
                  ("packed_forward_hist",))
    secs, stats, launches, arch = _compress_cuda(data_dir, "f", keys, steps,
                                                 HALVES)
    _check_counts("f", launches, {"packed_forward_hist": n},
                  ("forward_hist", "haar_forward"))
    if arch != ref or not arch:
        raise AssertionError("(f) archive differs from the default "
                             "layout's")
    box_secs, box_stats, box_l, box_arch = _compress_cuda(
        data_dir, "f_box", [f"keep={KEEP}", "transfer=sparse"], steps, HALVES)
    _check_counts("f, box transfer=sparse", box_l,
                  {"packed_forward": n, "compact_count": n,
                   "compact_scatter": n}, ("haar_forward",))
    if box_arch != _tree(os.path.join(WORK, "e_arch_cuda")):
        raise AssertionError("(f) box transfer=sparse archive differs from "
                             "(e)'s")
    return {"global": {"cuda_compress_s": secs, "launches": launches,
                       "global_threshold": stats["global_threshold"],
                       "archive_bytes": sum(len(b) for b in arch.values())},
            "box_sparse": {"cuda_compress_s": box_secs, "launches": box_l,
                           "device_to_host_bytes":
                               box_stats["device_to_host_bytes"]}}


def _estimate(data_dir: str, keys, device: str, env=None):
    """One ``-estimate`` on timestep 0, level 0: -> (result, launches)."""
    from wavelet_tpu_torch import cli
    from wavelet_tpu_torch.pipeline.estimate import estimate_run

    mode, cfg = cli.parse_argv([
        f"datadir={data_dir}", f"minfile={TIMESTEPS[0]}", "minlevel=0",
        "components=" + " ".join(COMPONENTS), *keys, f"device={device}",
        "-estimate"])
    assert mode == "estimate"
    with _env(env or {}):
        _reset_launches()
        result = estimate_run(cfg)
        return result, _launches()


def _metric_rows(result, prefix=()):
    """{(sweep key, component, metric): value} of an estimate result."""
    rows = {}
    for k, v in result.items():
        if isinstance(v, dict):
            rows.update(_metric_rows(v, prefix + (k,)))
        elif isinstance(v, float):
            rows[prefix + (k,)] = v
    return rows


def run_estimates(data_dir: str) -> dict:
    """(g): ``-estimate`` equal between device=cuda and cpu and between the
    layouts, the packed kernels on the halves route's scratch path,
    ``devicemetrics=1`` against the host metrics."""
    runs = {
        "scratch": [f"keep={KEEP}"],
        "fast_keep_sweep": ["fastestimate=1", "keep=0.99 0.999 0.9999"],
        "global_sweep": ["thresholdmode=global", "keepfraction=0.01 0.02"],
    }
    path = {"scratch": ("packed_forward", "packed_inverse"),
            "global_sweep": ("packed_forward_hist", "packed_inverse")}
    out = {}
    for what, keys in runs.items():
        results = {}
        for layout, env in (("default", None), ("halves", HALVES)):
            for dev in ("cuda", "cpu"):
                t0 = time.perf_counter()
                r, launches = _estimate(data_dir, keys, dev, env)
                results[(layout, dev)] = r
                if dev == "cuda" and layout == "halves" and what in path:
                    _check_counts(f"g, {what}", launches,
                                  dict.fromkeys(path[what], 1))
                    out[f"{what}_halves_launches"] = launches
                out[f"{what}_{layout}_{dev}_s"] = time.perf_counter() - t0
        want = results[("default", "cuda")]
        for key, r in results.items():
            if r != want:
                raise AssertionError(f"(g) {what}: {key} reports {r}, "
                                     f"default cuda {want}")
        out[what] = want
    dm, _ = _estimate(data_dir, [f"keep={KEEP}", "devicemetrics=1"], "cuda")
    host, got = _metric_rows(out["scratch"]), _metric_rows(dm)
    if host.keys() != got.keys():
        raise AssertionError(f"(g) devicemetrics keys {sorted(got)}")
    worst = 0.0
    for k, v in host.items():
        if k[-1] == "compressed_size_pct" or k[-1] == "keep":
            ok = got[k] == v
        else:
            if v:
                worst = max(worst, abs(got[k] - v) / abs(v))
            ok = abs(got[k] - v) <= 1e-5 * abs(v)
        if not ok:
            raise AssertionError(f"(g) devicemetrics {k}: {got[k]} vs host "
                                 f"{v}")
    out["devicemetrics_max_rel_err"] = worst
    return out


def run_check_info(name: str) -> dict:
    """-check and -info on (``name``)'s device=cuda archive."""
    import wavelet_tpu_torch

    arch = os.path.join(WORK, f"{name}_arch_cuda")
    chk = wavelet_tpu_torch.check(arch)
    inf = wavelet_tpu_torch.info(arch)
    n_payloads = sum(1 for k in _tree(arch) if k.endswith(".xz"))
    if chk["errors"] or chk["files"] != n_payloads:
        raise AssertionError(f"(-check) {chk}")
    if inf["members"] != n_payloads or inf["missing"]:
        raise AssertionError(f"(-info) {inf}")
    return {"check_files": chk["files"], "info_size_pct": inf["size_pct"],
            "info_total_bytes": inf["total_bytes"]}


def _time_ms(fn, x, reps: int = 7, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, by CUDA events."""
    import statistics

    import torch

    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn(x)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def run_sparse_decompress(name: str, done: dict) -> dict:
    """(``name``)'s device=cuda archive decompressed on the card with
    ``transfer=sparse``: the plotfiles must be that configuration's, with
    fewer bytes over the link."""
    comp = os.path.join(WORK, f"{name}_arch_cuda") + os.sep
    out = os.path.join(WORK, f"{name}_out_sparse") + os.sep
    _reset_launches()
    secs, ds = _run_cli([f"compresseddir={comp}", f"out={out}",
                         "transfer=sparse", "device=cuda", "-d"])
    launches = _launches()
    _check_counts(f"{name}, -d transfer=sparse", launches,
                  dict.fromkeys(("haar_inverse", "pyramid_inverse"), 1))
    if _tree(out) != _tree(os.path.join(WORK, f"{name}_out_cuda")):
        raise AssertionError(f"({name}) -d transfer=sparse plotfiles differ "
                             "from the dense run's")
    h2d, ref = ds["host_to_device_bytes"], done[name]["host_to_device_bytes"]
    if not 0 < h2d < ref:
        raise AssertionError(f"({name}) -d transfer=sparse shipped {h2d} "
                             f"bytes, not below dense {ref}")
    return {"cuda_decompress_s": secs, "host_to_device_bytes": h2d,
            "dense_host_to_device_bytes": ref, "launches": launches,
            "stages": {k: ds[k] for k in ("decompress_seconds",
                                          "unpack_seconds", "device_seconds",
                                          "write_seconds")}}


def _pair(kern, plain, inp) -> dict:
    """plain, kernel, kernel, plain: the mean of each pair."""
    p1 = _time_ms(plain, inp)
    k1 = _time_ms(kern, inp)
    k2 = _time_ms(kern, inp)
    p2 = _time_ms(plain, inp)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "runs_ms": [p1, k1, k2, p2]}


def _bound(nbytes: int) -> dict:
    return {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bound_bytes": nbytes}


def phase_timing(device, rows) -> dict:
    """Kernel, plain-version and library times; each kernel's bound; the
    link; the sparse-transfer stages.  ``rows`` = :func:`main_path_rows`."""
    import numpy as np
    import torch

    from wavelet_tpu_torch.kernels import (build, compact_cuda, haar_cuda,
                                           pyramid_cuda)
    from wavelet_tpu_torch.kernels.haar_cuda import _raise_if, _stream
    from wavelet_tpu_torch.runtime import engine

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(TIME_SHAPE, np.float32)).to(
        device)
    c = haar_cuda.fused_forward(x)[0]
    pyr = pyramid_cuda.pyramid_forward(x, TIME_SCALES)[0]
    s = TIME_SCALES
    pairs = {
        "haar_forward": (haar_cuda.fused_forward,
                         haar_cuda.fused_forward_plain, x),
        "haar_inverse": (haar_cuda.fused_inverse,
                         haar_cuda.fused_inverse_plain, c),
        "pyramid_forward": (lambda v: pyramid_cuda.pyramid_forward(v, s),
                            lambda v: pyramid_cuda.pyramid_forward_plain(
                                v, s), x),
        "forward_hist": (lambda v: pyramid_cuda.forward_hist(v, s),
                         lambda v: pyramid_cuda.forward_hist_plain(v, s), x),
        "pyramid_inverse": (lambda v: pyramid_cuda.pyramid_inverse(v, s),
                            lambda v: pyramid_cuda.pyramid_inverse_plain(
                                v, s), pyr),
    }
    out = {name: _pair(*v) for name, v in pairs.items()}
    # bounds: each input read once, each output written once; no single
    # PyTorch call computes a Haar transform or the float-bits histogram
    box = x.numel() * 4
    n_box = TIME_SHAPE[0]
    for name, extra in (("haar_forward", 8 * n_box), ("haar_inverse", 0),
                        ("pyramid_forward", 8 * n_box),
                        ("forward_hist", 2048 * 8), ("pyramid_inverse", 0)):
        out[name].update(_bound(2 * box + extra), library_ms=None)

    # the compaction on the main path's coefficient rows: each kernel
    # alone on preallocated buffers; its plain version is the whole plain
    # compaction (the two kernels' function); the library yardstick is
    # torch.nonzero, which gives positions only
    flat, t32, cap, counts = rows
    n, m = (int(d) for d in flat.shape)
    lib = build.library()
    n_tiles = int(lib.wt_compact_tiles(m))
    cnt = torch.empty((n, n_tiles), dtype=torch.int32, device=device)
    idx = torch.empty((n, cap), dtype=torch.int32, device=device)
    vals = torch.empty((n, cap), dtype=torch.float32, device=device)
    st = _stream(flat)

    def count(_):
        return lib.wt_compact_count(flat.data_ptr(), t32.data_ptr(),
                                    cnt.data_ptr(), n, m, st)

    _raise_if(count(None), lib, "compact_count")
    incl = torch.cumsum(cnt, dim=1, dtype=torch.int32)
    offs = incl - cnt

    def scatter(_):
        return lib.wt_compact_scatter(flat.data_ptr(), t32.data_ptr(),
                                      offs.data_ptr(), idx.data_ptr(),
                                      vals.data_ptr(), n, m, cap, st)

    _raise_if(scatter(None), lib, "compact_scatter")

    def plain(_):
        return compact_cuda.compact_plain(flat, t32, cap)

    def library(_):
        return torch.nonzero(torch.abs(flat) > t32[:, None])

    library_ms = _time_ms(library, None)
    written = int(np.minimum(counts, cap).sum())
    head = n * m * 4 + n * 4 + n * n_tiles * 4
    out["compact_count"] = {**_pair(count, plain, None), **_bound(head),
                            "library_ms": library_ms}
    out["compact_scatter"] = {**_pair(scatter, plain, None),
                              **_bound(head + 8 * written),
                              "library_ms": library_ms}
    # the whole compaction (wrapper: both kernels and the scan) is the
    # compress side's sparse stage: its rate is the d2h breakeven
    stage_ms = _time_ms(lambda _: compact_cuda.compact(flat, t32, cap), None)
    dense_gb = n * m * 4 / 1e9
    out["compaction"] = {"ms": stage_ms, "kept": int(counts.sum()),
                         "kept_fraction": float(counts.sum()) / (n * m),
                         "max_row_kept_fraction": float(counts.max()) / m,
                         "cap": cap, "pairs_written": written,
                         **_bound(n * m * 4 + n * 4 + 8 * written),
                         "stage_gbps": dense_gb / (stage_ms / 1e3)}
    # the decompress side's sparse stage: padded pairs as
    # HostPacker.unpack_sparse makes them, scattered into zeroed rows and
    # inverted (one scale, the main path's): its rate is the h2d
    # breakeven
    maxc = int(counts.max())
    pcap = min(max(256, 1 << (maxc - 1).bit_length()),
               1 << (m - 1).bit_length())
    pc, pidx, pvals = compact_cuda.compact(flat, t32, pcap)
    slot = torch.arange(pcap, device=device)
    pad = slot[None, :] >= pc[:, None]
    pidx = torch.where(pad, (m + slot).to(torch.int32)[None, :], pidx)
    pvals = torch.where(pad, torch.zeros((), device=device), pvals)
    dims = TIME_SHAPE[1:]

    def h2d_stage(_):
        return haar_cuda.fused_inverse(
            engine.CodecEngine.scatter_rows(pidx, pvals, dims))

    rows_ms = _time_ms(h2d_stage, None)
    out["scatter_inverse"] = {"ms": rows_ms, "pair_cap": pcap,
                              "stage_gbps": dense_gb / (rows_ms / 1e3)}
    out.update(_packed_timing(device))
    out["link_gbps"] = engine.CodecEngine._measure_link()
    return out


def _packed_timing(device) -> dict:
    """The lane-packed kernels at [80, 64, 64, 128] (the main path's 64^3
    boxes at P = 2, the bytes of K1/K2's [160, 64, 64, 64]), and at P = 64
    beside K1/K2 on the same bytes of 8x4x2 boxes."""
    import numpy as np
    import torch

    from wavelet_tpu_torch.kernels import haar_cuda, packed_cuda

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(PACKED_SHAPE, np.float32)).to(
        device)
    c = packed_cuda.packed_forward(x, 2)[0]
    out = {
        "packed_forward": _pair(lambda v: packed_cuda.packed_forward(v, 2),
                                lambda v: packed_cuda.packed_forward_plain(
                                    v, 2), x),
        "packed_inverse": _pair(lambda v: packed_cuda.packed_inverse(v, 2),
                                lambda v: packed_cuda.packed_inverse_plain(
                                    v, 2), c),
        "packed_forward_hist": _pair(
            lambda v: packed_cuda.packed_forward_hist(v, 2),
            lambda v: packed_cuda.packed_forward_hist_plain(v, 2), x),
    }
    box = x.numel() * 4
    n_box = PACKED_SHAPE[0] * 2
    for name, extra in (("packed_forward", 8 * n_box), ("packed_inverse", 0),
                        ("packed_forward_hist", 2048 * 8)):
        out[name].update(_bound(2 * box + extra), library_ms=None)
    # P = 64: K3/K4 on packed rows of 8x4x2 boxes, K1/K2 on the same boxes
    # one per row
    p = P64_SHAPE[-1] // 2
    xp = torch.from_numpy(rng.standard_normal(P64_SHAPE, np.float32)).to(
        device)
    xu = packed_cuda.unpack(xp, p).contiguous()
    cp = packed_cuda.packed_forward(xp, p)[0]
    cu = haar_cuda.fused_forward(xu)[0]
    runs = {"haar_forward": (haar_cuda.fused_forward, xu),
            "packed_forward": (lambda v: packed_cuda.packed_forward(v, p), xp),
            "haar_inverse": (haar_cuda.fused_inverse, cu),
            "packed_inverse": (lambda v: packed_cuda.packed_inverse(v, p),
                               cp)}
    # in turns: unpacked, packed, packed, unpacked
    p64 = {}
    for a, b in (("haar_forward", "packed_forward"),
                 ("haar_inverse", "packed_inverse")):
        t = [_time_ms(*runs[k]) for k in (a, b, b, a)]
        p64[a] = (t[0] + t[3]) / 2
        p64[b] = (t[1] + t[2]) / 2
        p64[f"{a}_runs_ms"], p64[f"{b}_runs_ms"] = [t[0], t[3]], [t[1], t[2]]
    out["p64"] = {"shape": list(P64_SHAPE), "unpacked_shape": list(xu.shape),
                  **p64, **_bound(2 * xp.numel() * 4)}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA GPU (no CPU fallback)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "wavelet_tpu_torch")):
        print(f"chip_smoke: no wavelet_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = _card()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    from wavelet_tpu_torch.kernels import build

    build.library()
    print(f"build: {build.build_seconds:.2f} s  flags: "
          f"{' '.join(build.NVCC_FLAGS)}")
    print(build.build_log.strip())

    shutil.rmtree(WORK, ignore_errors=True)
    data_dir = os.path.join(WORK, "data")
    t0 = time.perf_counter()
    nbytes = make_dataset(data_dir)
    print(f"dataset: {nbytes} f32 box bytes in {len(TIMESTEPS)} "
          f"timesteps, written in {time.perf_counter() - t0:.1f} s")
    rows = main_path_rows(data_dir, device)
    err = {**phase_kernels(device), **phase_pyramid_kernels(device),
           **phase_packed_kernels(device),
           **phase_compact_kernels(
               _compact_edge_cases(device)
               + [(f"main path [{TIME_SHAPE[0]}, {rows[0].shape[1]}] "
                   f"cap={rows[2]}", *rows[:3])])}
    print(f"phase 4 ok: kernels bitwise equal to plain versions "
          f"(max_abs_err {err})")
    launches = dict.fromkeys(KERNELS, 0)
    done = {}
    for name, keys, d_keys, steps, expect, bound, same_as, *opts in CONFIGS:
        t0 = time.perf_counter()
        e2e = done[name] = run_config(data_dir, nbytes, name, keys, d_keys,
                                      steps, expect, bound, same_as, done,
                                      *opts)
        for k, v in e2e["launches"].items():
            launches[k] += v
        print(f"end to end ({name}: {' '.join(keys + d_keys)}; {card}; "
              f"{time.perf_counter() - t0:.1f} s): " + json.dumps(e2e))
    t0 = time.perf_counter()
    sd = run_sparse_decompress("c", done)
    for k, v in sd["launches"].items():
        launches[k] += v
    print(f"end to end (c, -d transfer=sparse; {card}; "
          f"{time.perf_counter() - t0:.1f} s): " + json.dumps(sd))
    t0 = time.perf_counter()
    f = run_packed_compress(data_dir)
    for run in f.values():
        for k, v in run["launches"].items():
            launches[k] += v
    print(f"end to end (f, -c under WAVELET_TPU_LAYOUT=halves; {card}; "
          f"{time.perf_counter() - t0:.1f} s): " + json.dumps(f))
    t0 = time.perf_counter()
    g = run_estimates(data_dir)
    g.update(run_check_info("a"))
    print(f"estimate, check, info (g; {card}; "
          f"{time.perf_counter() - t0:.1f} s): " + json.dumps(g))
    timing = phase_timing(device, rows)
    shutil.rmtree(WORK, ignore_errors=True)
    print(f"kernel times at {list(TIME_SHAPE)}, pyramids at scales="
          f"{TIME_SCALES}, compaction on the main path's coefficient rows "
          f"({card}): " + json.dumps(timing))
    kernels = []
    for name, (replaces, source) in KERNELS.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
