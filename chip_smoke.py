#!/usr/bin/env python3
"""End-to-end smoke check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # one card
    python3 chip_smoke.py --kernels  # only the build, phase 4's Haar,
                                     # packed and compaction checks, the
                                     # kernels' times (the sweep, the
                                     # compaction and the histogram
                                     # passes on constant and ramp boxes
                                     # included); no result line

Phases (any failure exits non-zero before the last line):

1. ``torch.cuda.is_available()`` must hold: there is no CPU fallback.
2. Print the card's name and power limit (nvidia-smi).
3. Build the CUDA kernels from ``wavelet_tpu_torch/csrc`` with nvcc.
4. Each kernel against its plain PyTorch version on the card, bitwise
   (int32 views) on coefficients, per-box max and min, and exactly equal
   histograms: the paths' shapes at 1, 2 and 3 scales, odd shapes,
   subnormals, an exact ``min == -max`` tie, a box holding NaN, +-inf and
   signed zeros, and the edges of K1/K2's flat (box, cell) grid: more
   boxes than 65,535, single cells, tails on every axis, batches of 8x4x2
   and 8^3 boxes with a NaN box, a -0.0 box, a subnormal box, a tie box
   and an inf box among normal ones, one 256^3 box; the signed extrema
   ``resolve_signed_absmax`` takes from them equal the plain version's;
   then each inverse on the same shapes.  One exception: a
   zero extremum may come back as +0.0 from one and -0.0 from the other.
   The sign of a zero extremum cannot change ``|c| > t32`` (the threshold
   is then +-0 and no magnitude is below zero), so it cannot change an
   archive byte.  The compaction (the single-pass ``compact``) against
   its plain version, counts and the first ``count`` pairs bitwise: rows
   of 1 to 64^3 elements with NaN, +-inf, signed zeros, subnormals,
   thresholds negative, -0, +inf and NaN, rows that keep everything and a
   row whose kept prefix reaches the cap exactly at a tile boundary; row
   lengths at the 8192-element tile's edges (8191, 8192, 8193, 16387)
   and not a multiple of 4 (the scalar loads); 70,000 rows of 64 and of
   8195 elements; and the main path's [160, 262144] coefficient rows at
   the dataset's kept fraction.
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
   (a)'s archive.  (h) ``-d preview=1`` and ``preview=2`` (level 0) of
   (a)'s and (b)'s archives, equal on cuda and cpu and to the block mean
   of the full output (rtol 1e-5); a depth equal to the stored scales
   launches nothing and ships no bytes, one scale left launches K2, a
   deeper preview K2 and then the low-pass.  (i) The first timestep of (a)
   and of (c) through the API over a two-entry mesh (two cards where
   there are, else cuda:0 twice): (a)'s payloads and plotfiles, (c)'s
   archive without a mesh, every kernel launched once per row chunk.  (j)
   One 256^3 box (64 MiB f32, a 128 MiB f64 FAB) with
   ``giantbox=33554432`` over that mesh at ``scales=1`` and ``2``, -c
   then -d: the archive and plotfiles of the unsplit run, the slab kernels
   launched twice per box; then ``preview=2`` of the two-scale archive,
   the corner alone.  (k) ``python -m wavelet_tpu_torch.cli``'s main in
   two processes on the card (``coordinator=127.0.0.1:PORT processes=2
   processid=I``, under one deadline): ``-c`` of (a)'s first timestep
   equal to one process's archive and (a)'s payloads, ``-c`` of (c)'s
   first timestep with ``archive=bundle`` equal in its members to one
   process's, one bundle per rank, and ``-d`` of (a)'s archive equal to
   (a)'s plotfiles; then ``giantmesh=global`` in two processes with the
   default ``devices=`` (a global mesh of two entries of cuda:0, one per
   process), on two timesteps each holding a 128^3 box at
   ``giantbox=4194304`` and eight 64^3 boxes: box mode at ``scales=2``
   (-c, -c ``resume=1``, -d) and ``thresholdmode=global
   keepfraction=0.02`` with a ``globalcache`` of one timestep, every
   archive and plotfile equal to a one-process device=cpu run's, each
   child printing its launch counts, gloo bytes and wall.  (l) The
   collective steps (parity, global, train) over the two-entry
   mesh at [160, 64, 64, 64] against eight CPU entries, bitwise (the RMSE
   to rtol 1e-6), then ``dryrun_multichip(2)`` on the card.  (m) The
   measurement programs: ``python -m wavelet_tpu_torch.bench``'s main at
   [128, 64^3] with 3 reps (one JSON line, every stage with a rep used and
   none implausible, K1-K5 and the compaction launched; its round-trip
   RMSE and kept fraction at n = 16 equal on cuda and cpu), the scaling
   bench over [cuda:0, cuda:0] at [16, 64^3], the e2e bench's cube64 on 32
   boxes of 64^3 (its archives equal on cuda and cpu but for the sidecar
   that names the dataset's directory), its global64 on 2 timesteps of 32
   boxes of 64^3 in box mode, global mode with the default
   ``globalcache`` and global mode with ``globalcache=0`` (each mode's
   bundle equal on cuda and cpu but for those sidecars, equal thresholds,
   2 and 0 timesteps cached, K1 alone in box mode, K6 alone in both global
   modes and twice as often without the cache, nothing on cpu) and
   baseline config 6 on 16 boxes; its launches, which follow the timing
   loops' reps, are checked there and are not summed into the kernels
   line, but for global64's.  (n) The host benches at small size:
   ``scripts.bench_ragged --scale 0.01 --in-process`` (all 44 shapes,
   both levels, two timesteps) on both layouts with ``--compare-cpu``,
   archives and plotfiles byte-identical to the ``device=cpu`` run's, with
   K1/K2 launched on every bucket of the default route and K3/K4 on every
   bucket the halves route packs (K1/K2 on the others), each -c and -d
   cold and warm; ``scripts.bench_quality`` with its 32-box subset's
   metrics equal on cuda and cpu; ``scripts.fuzz_campaign --trials-per
   50`` with no backend disagreement;
   ``scripts.bench_host_codec`` and ``scripts.bench_plotfile_io`` at small
   sizes, each JSON naming this card and the host codec's device rate
   measured on it.  (n)'s launches, like those of (m)'s timed runs, are
   checked in (n) and left out of the kernels line.  The wall of each of
   (h)-(n) is printed on its own line.
6. Timing: kernel and plain-version times with CUDA events at the main
   path's 64^3 batch (the packed kernels on the same boxes packed two to
   a row, and at P = 64 beside K1/K2 on the same bytes of 8x4x2 boxes),
   each kernel's bound (its inputs read once and outputs written once at
   3.35 TB/s), the link rate, and the two sparse-transfer stage rates that
   set ``transfer=auto``'s breakevens.  The compaction on the main path's
   coefficient rows and on bench's ~1% kept rows: the launch with its
   scratch memset on preallocated buffers, the whole wrapper, the plain
   version and ``torch.nonzero``, each with the function's bound (one read
   of the rows, the pairs written).  ``forward_hist`` and
   ``packed_forward_hist`` on N(0, 1), constant and ramp boxes (each held
   exactly against its plain version first).  Then K1/K2's box-size sweep
   (:data:`SWEEP_SHAPES`, each shape bitwise against the plain versions,
   then timed through the wrappers and bare), printed on its own line.

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
# K1/K2's box-size sweep: each shape but the last is cut from the same
# 41,943,040 N(0, 1) floats (167.8 MB)
SWEEP_FLOATS = 41943040
SWEEP_SHAPES = [
    (655360, 8, 4, 2),      # the reference fixture's small box
    (81920, 8, 8, 8),       # AMReX amr.blocking_factor 8
    (10240, 16, 16, 16),
    (1280, 32, 32, 32),     # AMReX amr.max_grid_size 32 (3D)
    (8307, 9, 17, 33),      # odd extents on every axis
    (160, 64, 64, 64),      # the kernel table's row
    (20, 128, 128, 128),    # bench's large boxes
    (32, 64, 64, 64),       # bench_host_codec's batch
]
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
     PYRAMID_PATH + ("compact",), ("range", 0.02),
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
    "compact": ("wavelet_tpu/kernels/compact_pallas.py:196 (K8), "
                "wavelet_tpu/kernels/compact_pallas.py:344 (K10) and "
                "wavelet_tpu/kernels/compact_pallas.py:484 (K9)",
                "wavelet_tpu_torch/csrc/compact.cu"),
    "packed_forward": ("wavelet_tpu/kernels/haar_pallas.py:242 (K3)",
                       "wavelet_tpu_torch/csrc/packed.cu"),
    "packed_inverse": ("wavelet_tpu/kernels/haar_pallas.py:288 (K4)",
                       "wavelet_tpu_torch/csrc/packed.cu"),
    "packed_forward_hist": ("wavelet_tpu/kernels/haar_pallas.py:242 (K3, "
                            "the packed global pass with the histogram)",
                            "wavelet_tpu_torch/csrc/packed.cu"),
}
# (h): (archive, preview depth, extra -d keys, the only kernels the
# preview may launch).  preview=2 regenerates level 0 alone (maxlevel=0):
# level 1's 8x4x2 box does not divide by 4.  A depth equal to the stored
# scales slices the corner on the host and sends nothing over the link.
PREVIEWS = [("a", 1, [], ()), ("a", 2, ["maxlevel=0"], ("haar_inverse",)),
            ("b", 1, [], ("haar_inverse",)), ("b", 2, ["maxlevel=0"], ())]
# (j): one 256^3 box of one component (64 MiB of f32, a 128 MiB f64 FAB),
# split along X over the two-entry mesh once a box reaches GIANT_BYTES.
# A 512^3 box (giantbox=268435456) took this phase 26.9 s on one H100
# host and 67.5 s on another, over a 60 s budget: its 1 GiB f64 FAB is
# written five times and read four, and that host I/O varies by host.
GIANT_N = 256
GIANT_BYTES = 33554432
GIANT_STEP = "plt00300"
FORWARD = {1: "haar_forward", 2: "pyramid_forward"}
INVERSE = {1: "haar_inverse", 2: "pyramid_inverse"}
DEADLINE_S = 300           # (k): one deadline for both processes of a run
GLOBAL_STEPS = ["plt00400", "plt00500"]   # (k)'s giantmesh=global run
# (k)'s giant box: a 256^3 one made (k) 87.6 s longer on one H100 host
# (30.9 s on another), mostly host f64 I/O in each process
GLOBAL_N = 128
GLOBAL_GIANT_BYTES = 4194304
DEV = "cuda"               # the device of phases (h)-(k)


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
    # the flat (box, cell) geometry: more boxes than a grid dimension's
    # 65,535, single cells, tails on every axis, one giant-path box
    for shape in ((70000, 2, 2, 2), (4, 1, 1, 1), (3, 1, 2, 3),
                  (2, 9, 17, 33), (1, 256, 256, 256)):
        x = (rng.standard_normal(shape) * 50).astype(np.float32)
        cases.append((f"normal{list(shape)}", x))
    # many small boxes reduced side by side: special boxes among normal
    # ones, so that no box's extrema leak into a neighbour's
    for shape in ((4096, 8, 4, 2), (300, 8, 8, 8)):
        x = (rng.standard_normal(shape) * 50).astype(np.float32)
        n = shape[0]
        x[n // 3, 1, 1, 1] = np.array([0x7FFFFFFF], np.uint32).view(
            np.float32)[0]
        x[n // 3 + 1] = -0.0
        x[n // 3 + 2] = (rng.standard_normal(shape[1:]) * 1e-42).astype(
            np.float32)
        x[n // 3 + 3] = 0.0
        x[n // 3 + 3, 1, 0, 0] = 8.0     # an exact min == -max tie
        x[n - 1, 0, 0, 0] = np.inf
        cases.append((f"special{list(shape)}", x))
    return [(n, torch.from_numpy(x).to(device)) for n, x in cases]


def _check_signed(name, c, mx, mn, pc, pmx, pmn) -> None:
    """The signed extrema the threshold takes (ties broken on the
    coefficients) must be the plain version's; on a tie case every box is
    a tie whose first occurrence is +1."""
    import numpy as np

    from wavelet_tpu_torch.runtime import engine

    def signed(c, mx, mn):
        return engine.resolve_signed_absmax(
            mx.cpu().numpy(), mn.cpu().numpy(),
            row_getter=lambda i: c[i].reshape(-1).cpu().numpy())

    got = signed(c, mx, mn)
    np.testing.assert_array_equal(got, signed(pc, pmx, pmn), err_msg=name)
    if name.startswith("tie"):
        assert (got == 1.0).all(), got


def phase_kernels(device) -> dict:
    """Phase 4: kernel vs plain version on the card.  Returns the largest
    absolute error per kernel (0.0 when bitwise equal)."""
    import torch

    from wavelet_tpu_torch.kernels import haar_cuda

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
        _check_signed(name, c, mx, mn, pc, pmx, pmn)
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
    # more boxes than a grid dimension's 65,535; one cell at scale 1
    cases.append(("normal[70000,4,4,4]", normal((70000, 4, 4, 4)), 2))
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
    # forward_hist at one scale, where it takes odd shapes; 140,000 boxes
    # of 8x4x2 make each block of the capped grid walk several turns
    rng = np.random.default_rng(3)
    odd = [(f"normal{list(sh)}",
            torch.from_numpy((rng.standard_normal(sh) * 50).astype(
                np.float32)).to(device), 1)
           for sh in ((3, 33, 17, 9), (5, 8, 4, 2), (2, 1, 1, 1),
                      (140000, 8, 4, 2))]
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


# (m, cap) of the compaction's edge rows: short rows, lengths at the edges
# of the kernel's 8192-element tile, lengths that are not a multiple of 4
# (its scalar loads: 4093, 4094, 8191, 8193, 16387 and 15147 are 1, 2, 3,
# 1, 3 and 3 mod 4), and a 64^3 box's row
COMPACT_TILE = 8192
COMPACT_EDGES = [(1, 1), (16, 8), (64, 64), (4093, 517), (4094, 517),
                 (COMPACT_TILE - 1, 517), (COMPACT_TILE, 517),
                 (COMPACT_TILE + 1, 517), (2 * COMPACT_TILE + 3, 517),
                 (13824, 517), (3 * 33 * 17 * 9, 2000), (64 ** 3, 5248)]
# more rows than the old grid's 65,535: one tile and two tiles a row
COMPACT_MANY_ROWS = [(70000, 64, 16), (70000, COMPACT_TILE + 3, 200)]


def _compact_edge_cases(device):
    """(name, flat, t32, cap) cases for the compaction, from numpy seeds:
    each row set of :data:`COMPACT_EDGES` holds a ~1% row, a row past the
    cap, NaN and +-inf, zeros and signed zeros under thresholds -1 (which
    keeps the whole row) and -0, subnormals under a subnormal threshold,
    thresholds +inf and NaN, and a row whose kept prefix reaches the cap
    exactly at the end of the first tile; then :data:`COMPACT_MANY_ROWS`,
    with thresholds from -1 to 6."""
    import numpy as np
    import torch

    cases = []
    for m, cap in COMPACT_EDGES:
        rng = np.random.default_rng(m)
        flat = rng.standard_normal((10, m)).astype(np.float32)
        flat[rng.random((10, m)) < 0.01] *= 100
        t32 = np.full(10, 5.0, np.float32)
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
        # cap kept in the first tile, more after it
        first = min(m, COMPACT_TILE)
        flat[9] = 0.0
        flat[9, rng.choice(first, min(cap, first), replace=False)] = 50.0
        flat[9, first:][rng.random(m - first) < 0.05] = -50.0
        cases.append((f"edge[10,{m}] cap={cap}",
                      torch.from_numpy(flat).to(device),
                      torch.from_numpy(t32).to(device), cap))
    for n, m, cap in COMPACT_MANY_ROWS:
        rng = np.random.default_rng(n + m)
        flat = torch.from_numpy(rng.standard_normal((n, m), np.float32))
        t32 = rng.uniform(0.0, 6.0, n).astype(np.float32)
        t32[::7] = -1.0
        cases.append((f"rows[{n},{m}] cap={cap}", flat.to(device),
                      torch.from_numpy(t32).to(device), cap))
    return cases


def engine_cap(counts, m: int) -> int:
    """The pair capacity the engine adapts to after one batch of these
    counts (``compress_shapebatch_sparse``: 1.5x the largest kept
    fraction, rounded up to 128 slots)."""
    frac = min(0.25, max(float(counts.max()) / m * 1.5, 64 / m))
    return int(min(m, max(128, -(-int(m * frac) // 128) * 128)))


def main_path_boxes(data_dir: str):
    """Timestep 0's 160 boxes of 64^3 (4 components) as one f32 [160, 64,
    64, 64] host array: the main path's largest batch."""
    import numpy as np

    from wavelet_tpu_torch.io import plotfile

    boxes = []
    for lev in (0, 1):
        lv = plotfile.read_level(os.path.join(data_dir, TIMESTEPS[0]), lev,
                                 range(len(COMPONENTS)))
        boxes += [c for b in lv.boxes if b.shape[1:] == TIME_SHAPE[1:]
                  for c in b]
    x = np.stack(boxes).astype(np.float32)
    assert x.shape == TIME_SHAPE, x.shape
    return x


def main_path_rows(data_dir: str, device):
    """The main path's compaction input: :func:`main_path_boxes`'
    one-scale coefficients on the card as flat [160, 262144], the
    keep=0.999 thresholds, and the engine's adapted cap."""
    import torch

    from wavelet_tpu_torch.core import threshold
    from wavelet_tpu_torch.kernels import haar_cuda
    from wavelet_tpu_torch.runtime import engine

    x = torch.from_numpy(main_path_boxes(data_dir)).to(device)
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
    """Phase 4, compaction: the kernel vs its plain version on the card,
    counts and the first min(count, cap) pairs bitwise; returns the
    largest absolute error (0.0 when bitwise equal) of the counts and
    pairs."""
    import torch

    from wavelet_tpu_torch.kernels import compact_cuda

    err = 0.0
    for name, flat, t32, cap in cases:
        counts, idx, vals = compact_cuda.compact(flat, t32, cap)
        pcounts, pidx, pvals = compact_cuda.compact_plain(flat, t32, cap)
        torch.cuda.synchronize()
        ok_count = bool((counts == pcounts).all())
        err = max(err, float((counts.long() - pcounts.long()).abs().max()))
        # the slots a consumer reads: j < min(count, cap) of each row
        keep = (torch.arange(cap, device=flat.device)[None, :]
                < pcounts.clamp(max=cap)[:, None])
        ok_pairs = ok_count and (bool((idx[keep] == pidx[keep]).all())
                                 and _bits_equal(vals[keep], pvals[keep]))
        if ok_count and bool(keep.any()):
            err = max(err,
                      float((idx[keep].long() - pidx[keep].long()).abs()
                            .max()),
                      _max_abs_err(vals[keep], pvals[keep]))
        kept = int(pcounts.sum())
        print(f"  compact {name}: kept {kept} of {flat.numel()}, counts "
              f"bitwise={ok_count}, pairs bitwise={ok_pairs}")
        if not (ok_count and ok_pairs):
            raise AssertionError(f"compaction kernel != plain on {name}")
    return {"compact": err}


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
                  {"packed_forward": n, "compact": n}, ("haar_forward",))
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


def _expect_launches(name: str, launches: dict, want: dict) -> None:
    """Exact launch counts: ``want``'s kernels as given, every other 0."""
    full = {k: want.get(k, 0) for k in launches}
    if launches != full:
        raise AssertionError(f"({name}) launches {launches}, expected "
                             f"{full}")


def _lowpass(a, depth: int):
    """``depth`` rounds of 2x2x2 block means over the last three axes, in
    float32 with one rounding per combine (Z, Y, X per round)."""
    import numpy as np

    a = np.asarray(a, np.float32)
    half = np.float32(0.5)
    for _ in range(depth):
        a = (a[..., 0::2] + a[..., 1::2]) * half
        a = (a[..., 0::2, :] + a[..., 1::2, :]) * half
        a = (a[..., 0::2, :, :] + a[..., 1::2, :, :]) * half
    return a


def _preview_rel_err(full_dir: str, prev_dir: str, depth: int,
                     n_levels: int, n_comps: int = len(COMPONENTS)) -> float:
    """Largest |preview - block mean of the full output| / max(|mean|,
    0.1) over every box; raises past rtol 1e-5, atol 1e-6 (as the JAX
    package's tests/test_preview.py holds it)."""
    import numpy as np

    from wavelet_tpu_torch.io import plotfile

    comps = range(n_comps)
    worst = 0.0
    for ts in sorted(os.listdir(prev_dir)):
        for lev in range(n_levels):
            full = plotfile.read_level(os.path.join(full_dir, ts), lev, comps)
            prev = plotfile.read_level(os.path.join(prev_dir, ts), lev, comps)
            assert len(full.boxes) == len(prev.boxes)
            for fb, pb in zip(full.boxes, prev.boxes):
                want = _lowpass(fb, depth)
                assert pb.shape == want.shape, (pb.shape, want.shape)
                np.testing.assert_allclose(pb, want, rtol=1e-5, atol=1e-6)
                worst = max(worst, float((np.abs(pb - want) / np.maximum(
                    np.abs(want), 0.1)).max()))
    return worst


def run_previews(done: dict) -> dict:
    """(h): ``-d preview=P`` of (a)'s (one scale) and (b)'s (two scales)
    archives with device=cuda and device=cpu: the plotfiles must be equal,
    each the ``P``-fold block mean of the full ``-d`` output, and only the
    kernels of ``PREVIEWS`` may launch: none (and no link bytes) where P
    equals the stored scales."""
    out = {}
    for name, depth, keys, path in PREVIEWS:
        run = f"{name}_preview{depth}"
        comp = os.path.join(WORK, f"{name}_arch_cuda") + os.sep
        res, trees = {}, []
        for dev in (DEV, "cpu"):
            dst = os.path.join(WORK, f"{run}_{dev}") + os.sep
            _reset_launches()
            secs, ds = _run_cli([f"compresseddir={comp}", f"out={dst}",
                                 f"preview={depth}", *keys, f"device={dev}",
                                 "-d"])
            trees.append(_tree(dst))
            if dev == DEV:
                res = {"cuda_decompress_s": secs, "launches": _launches(),
                       "host_to_device_bytes": ds["host_to_device_bytes"],
                       "device_seconds": ds["device_seconds"],
                       "full_host_to_device_bytes":
                           done[name]["host_to_device_bytes"]}
            else:
                res["cpu_decompress_s"] = secs
        if trees[0] != trees[1] or not trees[0]:
            raise AssertionError(f"({run}) plotfiles differ between "
                                 "device=cuda and cpu")
        _check_counts(run, res["launches"], dict.fromkeys(path, 1),
                      [k for k in KERNELS if k not in path])
        if (res["host_to_device_bytes"] == 0) != (not path):
            raise AssertionError(f"({run}) shipped "
                                 f"{res['host_to_device_bytes']} bytes")
        res["max_rel_err_to_blockmean"] = _preview_rel_err(
            os.path.join(WORK, f"{name}_out_cuda"),
            os.path.join(WORK, f"{run}_{DEV}"), depth,
            1 if "maxlevel=0" in keys else 2)
        out[run] = res
    return out


def _two_entry_mesh():
    """Two mesh entries: two cards where there are, else cuda:0 twice."""
    import torch

    from wavelet_tpu_torch.runtime import mesh as mesh_lib

    if DEV == "cpu":
        return mesh_lib.data_mesh(["cpu", "cpu"])
    n = 2 if torch.cuda.device_count() >= 2 else 1
    return mesh_lib.data_mesh([f"cuda:{i % n}" for i in range(2)])


def _api_run(data_dir: str, name: str, steps, mesh, c_opts: dict,
             d_opts=None, components=COMPONENTS, max_level: int = 1,
             device: str | None = None) -> dict:
    """``wavelet_tpu_torch.compress`` then ``decompress`` on ``device``
    (``DEV`` by default) over ``mesh``: -> wall seconds, pipeline stats,
    launch counts and the archive and plotfile trees."""
    import wavelet_tpu_torch

    device = device or DEV

    comp = os.path.join(WORK, f"{name}_arch") + os.sep
    out = os.path.join(WORK, f"{name}_out") + os.sep
    _reset_launches()
    t0 = time.perf_counter()
    cs = wavelet_tpu_torch.compress(
        data_dir, comp, min_time=steps[0], max_time=steps[-1],
        components=list(components), min_level=0, max_level=max_level,
        device=device, mesh=mesh, **c_opts)
    t1 = time.perf_counter()
    ds = wavelet_tpu_torch.decompress(comp, out, device=device, mesh=mesh,
                                      **(d_opts or {}))
    return {"compress_s": t1 - t0, "decompress_s": time.perf_counter() - t1,
            "device_to_host_bytes": cs["device_to_host_bytes"],
            "host_to_device_bytes": ds["host_to_device_bytes"],
            "launches": _launches(), "arch": _tree(comp), "out": _tree(out)}


def _payloads_of_first_step(name: str) -> dict:
    """(``name``)'s device=cuda payload files of timestep 0."""
    return {k: v for k, v in _tree(os.path.join(WORK, f"{name}_arch_cuda"))
            .items() if k.startswith("compressed-wavelet-0-")}


def _first_step_plotfiles(name: str) -> dict:
    return {k: v for k, v in _tree(os.path.join(WORK, f"{name}_out_cuda"))
            .items() if k.startswith(TIMESTEPS[0] + os.sep)}


def _summary(r: dict) -> dict:
    return {k: v for k, v in r.items() if k not in ("arch", "out")}


def run_mesh(data_dir: str) -> dict:
    """(i): the first timestep of (a) and of (c) through the API over a
    two-entry mesh: every batch splits into two row chunks, each run by
    its kernel on its entry.  (a)'s payloads and plotfiles must be (a)'s;
    (c)'s archive and plotfiles those of the same run without a mesh (a
    one-timestep histogram gives its own threshold), on the card and on
    the CPU (the plain versions); every kernel of the path launches once
    per chunk, twice per unsplit launch."""
    mesh = _two_entry_mesh()
    steps = TIMESTEPS[:1]
    n_buckets = _n_buckets(data_dir, steps)
    out = {"mesh": [str(d) for d in mesh.devices]}
    a = _api_run(data_dir, "i_a", steps, mesh, {"keep": KEEP})
    _expect_launches("i, a", a["launches"],
                     {"haar_forward": 2 * n_buckets,
                      "haar_inverse": 2 * n_buckets})
    payloads = _payloads_of_first_step("a")
    if {k: v for k, v in a["arch"].items() if k.endswith(".xz")} \
            != payloads or not payloads:
        raise AssertionError("(i, a) payloads differ from (a)'s")
    if a["out"] != _first_step_plotfiles("a"):
        raise AssertionError("(i, a) plotfiles differ from (a)'s")
    out["a"] = {**_summary(a), "payloads_equal_to_a": len(payloads)}
    c_opts = {"threshold_mode": "global", "keep_fraction": 0.02, "scales": 2}
    cpu = _api_run(data_dir, "i_c_cpu", steps, None, c_opts, device="cpu")
    _expect_launches("i, c, cpu", cpu["launches"], {})
    one = _api_run(data_dir, "i_c_one", steps, None, c_opts)
    c = _api_run(data_dir, "i_c", steps, mesh, c_opts)
    _expect_launches("i, c", c["launches"],
                     {k: 2 * n for k, n in one["launches"].items()})
    for which, r in (("without a mesh", one), ("over the mesh", c)):
        if r["arch"] != cpu["arch"] or r["out"] != cpu["out"] \
                or not cpu["arch"]:
            raise AssertionError(f"(i, c) archive or plotfiles {which} "
                                 "differ from the device=cpu run")
    out["c"], out["c_no_mesh"] = _summary(c), _summary(one)
    out["c_cpu"] = _summary(cpu)
    return out


def make_giant_dataset(data_dir: str, n: int) -> int:
    """One timestep holding one ``n``^3 box of one component (f64 FAB);
    returns its f32 bytes."""
    import numpy as np

    from wavelet_tpu_torch.io import plotfile

    rng = np.random.default_rng(3)
    box = _field((n, n, n), (0, 0, 0), 1.0 / n, 0, 0, rng)
    plotfile.write_plotfile(
        os.path.join(data_dir, GIANT_STEP), [[box[None]]], [[(0, 0, 0)]],
        [[(n, n, n)]], ["density"], 0.003, [0.0, 0.0, 0.0], [1.0, 1.0, 1.0],
        (2, 2, 2), (n, n, n), [300])
    return box.nbytes


class _LogLines:
    """Collects the port's log messages (INFO and up) inside a block."""

    def __enter__(self):
        import logging

        self.lines = []
        lines = self.lines

        class _Handler(logging.Handler):
            def emit(self, record):
                lines.append(record.getMessage())

        self.log = logging.getLogger("wavelet_tpu_torch")
        self.handler, self.level = _Handler(), self.log.level
        self.log.addHandler(self.handler)
        self.log.setLevel(logging.INFO)
        return self.lines

    def __exit__(self, *exc):
        self.log.removeHandler(self.handler)
        self.log.setLevel(self.level)


def run_giant() -> dict:
    """(j): one GIANT_N^3 box over the two-entry mesh with
    ``giantbox=GIANT_BYTES`` at scales 1 and 2 (``codec=raw``: one item is
    one single-threaded xz stream): the archive and plotfiles must be the
    same run's without a mesh, on the card and with device=cpu (the plain
    versions of the slab kernels, on the whole box), the giant path must
    run (its log line), and the slab kernels launch twice, once per
    X-slab.  Then ``preview=2`` of the two-scale archive takes the stored
    corner alone: no launch, no link bytes, the same plotfiles on the
    card, over the mesh and on the CPU."""
    from wavelet_tpu_torch.runtime import engine

    data_dir = os.path.join(WORK, "giant_data")
    t0 = time.perf_counter()
    nbytes = make_giant_dataset(data_dir, GIANT_N)
    out = {"box": [GIANT_N] * 3, "input_bytes": nbytes,
           "giant_box_bytes": GIANT_BYTES,
           "dataset_s": time.perf_counter() - t0}
    mesh = _two_entry_mesh()
    dims = (GIANT_N,) * 3
    if not engine.CodecEngine(device=DEV, mesh=mesh,
                              giant_box_bytes=GIANT_BYTES).giant_ok(dims):
        raise AssertionError(f"(j) {dims} is not giant at {GIANT_BYTES}")
    giant = {"giant_box_bytes": GIANT_BYTES}
    # (name, mesh, giant options, device, slab launches of each kernel)
    variants = (("cpu", None, {}, "cpu", 0), ("one", None, {}, DEV, 1),
                ("mesh", mesh, giant, DEV, 2))
    for scales in (1, 2):
        runs = {}
        for which, m, opts, dev, n in variants:
            with _LogLines() as lines:
                r = _api_run(data_dir, f"j{scales}_{which}", [GIANT_STEP], m,
                             {"keep": KEEP, "scales": scales, "codec": "raw",
                              **opts}, opts, ["density"], 0, dev)
            r["giant_path"] = sum("Giant box path" in s for s in lines)
            _expect_launches(f"j, scales={scales}, {which}", r["launches"],
                             {FORWARD[scales]: n, INVERSE[scales]: n}
                             if n else {})
            if (r["giant_path"] > 0) != (m is not None):
                raise AssertionError(f"(j, scales={scales}, {which}) giant "
                                     f"path logged {r['giant_path']} times")
            runs[which] = r
        for which in ("one", "mesh"):
            if runs[which]["arch"] != runs["cpu"]["arch"] or \
                    runs[which]["out"] != runs["cpu"]["out"] or \
                    not runs["cpu"]["arch"]:
                raise AssertionError(f"(j, scales={scales}, {which}) archive "
                                     "or plotfiles differ from the "
                                     "device=cpu run")
        out[f"scales{scales}"] = {k: _summary(v) for k, v in runs.items()}
    import wavelet_tpu_torch

    comp = os.path.join(WORK, "j2_mesh_arch")
    trees = {}
    for which, m, opts, dev, _ in variants:
        dst = os.path.join(WORK, f"j_preview_{which}")
        _reset_launches()
        t0 = time.perf_counter()
        ds = wavelet_tpu_torch.decompress(comp, dst, device=dev, mesh=m,
                                          preview=2, **opts)
        out[f"preview2_{which}"] = {
            "decompress_s": time.perf_counter() - t0,
            "host_to_device_bytes": ds["host_to_device_bytes"],
            "launches": _launches()}
        _expect_launches(f"j, preview=2, {which}", _launches(), {})
        if ds["host_to_device_bytes"]:
            raise AssertionError("(j) preview=2 shipped "
                                 f"{ds['host_to_device_bytes']} bytes")
        trees[which] = _tree(dst)
    if trees["mesh"] != trees["cpu"] or trees["one"] != trees["cpu"] or \
            not trees["cpu"]:
        raise AssertionError("(j) preview=2 plotfiles differ")
    out["preview2_rel_err_to_blockmean"] = _preview_rel_err(
        os.path.join(WORK, "j2_mesh_out"),
        os.path.join(WORK, "j_preview_mesh"), 2, 1, 1)
    return out


# a child of (k): the CLI's own main, then its launch counts, the bytes
# it sent to gloo collectives of runtime/distributed, and its wall
CHILD = """import json, sys, time
t0 = time.perf_counter()
from wavelet_tpu_torch import cli
from wavelet_tpu_torch.kernels import (compact_cuda, haar_cuda,
                                       packed_cuda, pyramid_cuda)
from wavelet_tpu_torch.runtime import distributed
rc = cli.main(sys.argv[1:])
counts = {}
for mod in (haar_cuda, pyramid_cuda, compact_cuda, packed_cuda):
    counts.update(mod.launches)
print("launches " + json.dumps(counts))
print("gloo " + json.dumps(distributed.gloo_bytes))
print("wall " + json.dumps(time.perf_counter() - t0))
sys.exit(rc)
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_procs(name: str, args, n_procs: int):
    """``n_procs`` CLI processes (a gloo process group on localhost when
    more than one) under one deadline: a process that fails or outlives
    it ends the run and every process still running is killed.  -> (wall
    seconds, per process: its launch counts, gloo bytes, own wall and
    log)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    logs = [os.path.join(WORK, f"{name}_p{i}.log") for i in range(n_procs)]
    procs = []
    t0 = time.perf_counter()
    try:
        for i, path in enumerate(logs):
            group = ([f"coordinator=127.0.0.1:{port}",
                      f"processes={n_procs}", f"processid={i}"]
                     if n_procs > 1 else [])
            with open(path, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", CHILD, *args, *group,
                     f"device={DEV}"], cwd=REPO, env=env, stdout=f,
                    stderr=subprocess.STDOUT))
        end = time.monotonic() + DEADLINE_S
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() > end:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    out = []
    for i, (p, path) in enumerate(zip(procs, logs)):
        with open(path) as f:
            text = f.read()
        if p.returncode != 0:
            raise AssertionError(f"({name}) process {i} of {n_procs} exited "
                                 f"{p.returncode}:\n{text[-3000:]}")
        lines = {line.split(" ", 1)[0]: json.loads(line.split(" ", 1)[1])
                 for line in text.splitlines()
                 if line.split(" ", 1)[0] in ("launches", "gloo", "wall")}
        out.append({"launches": lines["launches"],
                    "gloo_bytes": lines["gloo"], "wall_s": lines["wall"],
                    "log": text})
    return wall, out


def _counts(procs) -> list:
    return [p["launches"] for p in procs]


def _launch_dicts(res):
    """Every launch-count dict in a phase's result: the values of its
    ``launches`` keys, at any depth, a list of dicts for (k)'s
    processes."""
    if isinstance(res, dict):
        for k, v in res.items():
            if k == "launches":
                yield from (v if isinstance(v, list) else [v])
            else:
                yield from _launch_dicts(v)


def _each_launched(name: str, launches, kernel: str) -> None:
    for i, counts in enumerate(launches):
        if counts[kernel] < 1:
            raise AssertionError(f"({name}) process {i} launched no "
                                 f"{kernel}: {counts}")


def run_two_processes(data_dir: str) -> dict:
    """(k): CLI processes on the one card (``coordinator=127.0.0.1:PORT
    processes=2 processid=I``; each works on ``cuda:(I % cards)``).  ``-c``
    of (a)'s first timestep in one and in two processes: the archives equal
    and the payloads (a)'s; ``-c`` of (c)'s first timestep with
    ``archive=bundle`` in two processes (the histograms summed over gloo):
    the bundle members equal a single-process device=cpu run's (the plain
    versions of the kernels), each process's bundle
    named by its rank; ``-d`` of (a)'s archive in one and in two processes
    (a timestep each): (a)'s plotfiles."""
    from wavelet_tpu_torch.io import bundle

    step = TIMESTEPS[0]

    def c_args(comp, keys):
        return [f"datadir={data_dir}", f"minfile={step}", f"maxfile={step}",
                "minlevel=0", "maxlevel=1",
                "components=" + " ".join(COMPONENTS), *keys,
                f"compresseddir={comp}", "-c"]

    out, archs = {}, {}
    for n in (1, 2):
        comp = os.path.join(WORK, f"k_a{n}_arch") + os.sep
        wall, procs = _cli_procs(f"k_a{n}", c_args(comp, [f"keep={KEEP}"]),
                                 n)
        counts = _counts(procs)
        _each_launched(f"k, -c a, {n} process(es)", counts, "haar_forward")
        archs[n] = _tree(comp)
        out[f"a_compress_{n}p"] = {"wall_s": wall, "launches": counts}
    payloads = _payloads_of_first_step("a")
    if archs[2] != archs[1] or not payloads or \
            {k: v for k, v in archs[2].items() if k.endswith(".xz")} \
            != payloads:
        raise AssertionError("(k) two-process -c differs from one process "
                             "or from (a)'s payloads")
    keys = ["thresholdmode=global", "keepfraction=0.02", "scales=2",
            "archive=bundle"]
    one = os.path.join(WORK, "k_c1_arch") + os.sep
    _run_cli(c_args(one, keys) + ["device=cpu"])
    two = os.path.join(WORK, "k_c2_arch") + os.sep
    wall, procs = _cli_procs("k_c2", c_args(two, keys), 2)
    counts = _counts(procs)
    _each_launched("k, -c c bundle", counts, "forward_hist")
    names = bundle.list_bundles(two)
    sets = [bundle.BundleSet(d) for d in (one, two)]
    if (sorted(names) != [bundle.bundle_name(0, p) for p in (0, 1)]
            or set(sets[0].keys()) != set(sets[1].keys())
            or any(sets[0].blob(*k) != sets[1].blob(*k)
                   for k in sets[0].keys())):
        raise AssertionError(f"(k) two-process bundles {names} differ from "
                             "the single-process run's members")
    sidecars = [{k: v for k, v in _tree(d).items() if k not in names
                 and not k.endswith(".wtb")} for d in (one, two)]
    if sidecars[0] != sidecars[1]:
        raise AssertionError("(k) two-process sidecars differ")
    out["c_bundle_compress_2p"] = {"wall_s": wall, "launches": counts,
                                   "bundles": names,
                                   "members": len(sets[1].keys())}
    comp = os.path.join(WORK, "a_arch_cuda") + os.sep
    want = _tree(os.path.join(WORK, "a_out_cuda"))
    for n in (1, 2):
        dst = os.path.join(WORK, f"k_d{n}_out") + os.sep
        wall, procs = _cli_procs(
            f"k_d{n}", [f"compresseddir={comp}", f"out={dst}", "-d"], n)
        counts = _counts(procs)
        _each_launched(f"k, -d a, {n} process(es)", counts, "haar_inverse")
        if _tree(dst) != want:
            raise AssertionError(f"(k) -d in {n} process(es) differs from "
                                 "(a)'s plotfiles")
        out[f"a_decompress_{n}p"] = {"wall_s": wall, "launches": counts}
    out["giantmesh_global"] = run_giant_global()
    return out


def make_giant_global_dataset(data_dir: str, n: int) -> int:
    """(k)'s giantmesh=global run: GLOBAL_STEPS, one component, each
    timestep one ``n``^3 box at the origin and eight 64^3 boxes beside it
    (f64 FABs); returns one timestep's f32 bytes."""
    import numpy as np

    from wavelet_tpu_torch.io import plotfile

    rng = np.random.default_rng(4)
    locs = [(0, 0, 0)] + [(n + 64 * i, 64 * j, 64 * k) for i in range(2)
                          for j in range(2) for k in range(2)]
    dims = [(n, n, n)] + [(64, 64, 64)] * 8
    nbytes = 0
    for t, name in enumerate(GLOBAL_STEPS):
        boxes = [_field(d, o, 1.0 / n, t, 0, rng)[None]
                 for o, d in zip(locs, dims)]
        nbytes = sum(b.nbytes for b in boxes)
        plotfile.write_plotfile(
            os.path.join(data_dir, name), [boxes], [locs], [dims],
            ["density"], 0.004 + 0.001 * t, [0.0, 0.0, 0.0],
            [1.0, 1.0, 1.0], (2, 2, 2), (n + 128, n, n), [400 + 100 * t])
    return nbytes


def run_giant_global() -> dict:
    """(k), ``giantmesh=global``: two CLI processes on the one card with
    the default ``devices=``, so a global mesh of two entries of cuda:0,
    one per process.  Each timestep holds one GLOBAL_N^3 box
    (``giantbox=GLOBAL_GIANT_BYTES``, ``codec=raw``) and eight 64^3 boxes;
    each process owns one timestep's items and takes part in both giant
    boxes (its X-slab on its entry, the slab pyramids gathered over
    gloo).  Box mode at ``scales=2`` (-c, -c resume=1, -d) and ``thresholdmode=global
    keepfraction=0.02`` with a ``globalcache`` that holds one of the two
    timesteps, each archive and plotfile byte for byte a one-process
    device=cpu run's; both logs show the global mesh and the giant path,
    and each process launches its slab kernels."""
    data_dir = os.path.join(WORK, "giant_global_data")
    t0 = time.perf_counter()
    t_bytes = make_giant_global_dataset(data_dir, GLOBAL_N)
    out = {"box": [GLOBAL_N] * 3, "timestep_bytes": t_bytes,
           "dataset_s": time.perf_counter() - t0}
    cache = t_bytes + t_bytes // 2     # one timestep, not two

    def c_args(comp, keys):
        return [f"datadir={data_dir}", f"minfile={GLOBAL_STEPS[0]}",
                f"maxfile={GLOBAL_STEPS[-1]}", "minlevel=0", "maxlevel=0",
                "components=density", f"giantbox={GLOBAL_GIANT_BYTES}",
                "codec=raw", *keys, f"compresseddir={comp}", "-c"]

    box = [f"keep={KEEP}", "scales=2"]
    glob = ["thresholdmode=global", "keepfraction=0.02",
            f"globalcache={cache}"]
    ref = {k: os.path.join(WORK, f"kg_{k}_cpu") + os.sep
           for k in ("box", "box_out", "global")}
    t0 = time.perf_counter()
    _run_cli(c_args(ref["box"], box) + ["device=cpu"])
    _run_cli([f"compresseddir={ref['box']}", f"out={ref['box_out']}",
              "device=cpu", "-d"])
    _run_cli(c_args(ref["global"], glob) + ["device=cpu"])
    out["cpu_reference_s"] = time.perf_counter() - t0
    two = {k: os.path.join(WORK, f"kg_{k}_2p") + os.sep
           for k in ("box", "box_out", "global")}
    gm = ["giantmesh=global"]
    runs = (("box_compress", c_args(two["box"], box + gm), "box",
             "pyramid_forward", "Giant box path"),
            ("box_resume", c_args(two["box"], box + gm + ["resume=1"]),
             "box", "pyramid_forward", "Giant box path"),
            ("box_decompress", [f"compresseddir={two['box']}",
                                f"out={two['box_out']}",
                                f"giantbox={GLOBAL_GIANT_BYTES}", *gm,
                                "-d"],
             "box_out", "pyramid_inverse", None),
            ("global_compress", c_args(two["global"], glob + gm), "global",
             "forward_hist", "retained 1/2"))
    for name, args, which, kernel, line in runs:
        wall, procs = _cli_procs(f"kg_{name}", args, 2)
        for i, p in enumerate(procs):
            for want in ("giantmesh=global", line):
                if want and want not in p["log"]:
                    raise AssertionError(f"(k, {name}) process {i} logged "
                                         f"no {want!r}:\n{p['log'][-3000:]}")
            if not p["gloo_bytes"]["all_gather"]:
                raise AssertionError(f"(k, {name}) process {i} gathered "
                                     "nothing over gloo")
        _each_launched(f"k, {name}", _counts(procs), kernel)
        if _tree(two[which]) != _tree(ref[which]) or not _tree(ref[which]):
            raise AssertionError(f"(k, {name}) output differs from the "
                                 "one-process device=cpu run's")
        out[name] = {"wall_s": wall,
                     "launches": [p["launches"] for p in procs],
                     "gloo_bytes": [p["gloo_bytes"] for p in procs],
                     "process_wall_s": [p["wall_s"] for p in procs]}
    return out


def run_steps(data_dir: str) -> dict:
    """(l): the collective steps over the two-entry mesh at the
    main path's width (:func:`main_path_boxes`, [160, 64, 64, 64] f32)
    against the same steps over eight CPU entries: coefficients,
    thresholds, kept counts and reconstructions bitwise, the RMSE to rtol
    1e-6; each step's kernels launched once per entry.  Then
    ``dryrun_multichip(2)`` on the card."""
    import numpy as np

    from wavelet_tpu_torch import entry
    from wavelet_tpu_torch.runtime import distributed
    from wavelet_tpu_torch.runtime import mesh as mesh_lib

    batch = main_path_boxes(data_dir)
    meshes = {"cuda": _two_entry_mesh(),
              "cpu": mesh_lib.data_mesh(["cpu"] * 8)}
    steps = {
        "parity": (distributed.make_parity_compress_step,
                   {"haar_forward": 2}),
        "global": (lambda m: distributed.make_global_compress_step(m, 0.02),
                   {"forward_hist": 2}),
        "train": (lambda m: distributed.make_train_step(m, 0.02),
                  {"forward_hist": 2, "haar_inverse": 2}),
    }
    out = {"mesh": [str(d) for d in meshes["cuda"].devices],
           "shape": list(batch.shape)}
    for name, (make, want) in steps.items():
        res, row = {}, {}
        for dev, mesh in meshes.items():
            _reset_launches()
            t0 = time.perf_counter()
            res[dev] = make(mesh)(batch)
            row[f"{dev}_s"] = time.perf_counter() - t0
            row[f"{dev}_launches"] = _launches()
        _expect_launches(f"l, {name}, cuda", row["cuda_launches"], want)
        _expect_launches(f"l, {name}, cpu", row["cpu_launches"], {})
        row["launches"] = row.pop("cuda_launches")
        del row["cpu_launches"]
        for k, (a, b) in enumerate(zip(res["cuda"], res["cpu"])):
            if name == "train" and k == 2:
                if not np.isclose(a, b, rtol=1e-6, atol=0):
                    raise AssertionError(f"(l, train) RMSE {a} against {b}")
                row["rmse"] = float(a)
            elif name == "global" and k == 2:
                # the limbs are sums of per-entry counts, so they depend
                # on the entry count; the count they make does not
                if distributed.kept_count(a) != distributed.kept_count(b):
                    raise AssertionError(f"(l, global) kept {a} against {b}")
            elif not np.array_equal(
                    np.ascontiguousarray(a).reshape(-1).view(np.uint8),
                    np.ascontiguousarray(b).reshape(-1).view(np.uint8)):
                raise AssertionError(f"(l, {name}) output {k} differs from "
                                     "the eight CPU entries'")
        if name == "global":
            row["kept"] = distributed.kept_count(res["cuda"][2])
            row["threshold"] = float(res["cuda"][1])
        out[name] = row
    t0 = time.perf_counter()
    _reset_launches()
    out["dryrun_multichip_2"] = {**entry.dryrun_multichip(2),
                                 "s": time.perf_counter() - t0,
                                 "launches": _launches()}
    return out


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output captured: -> (result, the
    output's lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args)
    return res, buf.getvalue().splitlines()


# (m): the stages of the device-stage bench that report reps, and the
# kernels its run must launch
BENCH_STAGES = ("forward", "forward_packed", "mask", "inverse",
                "inverse_packed", "sparse_compact_stage",
                "sparse_scatter_stage")
BENCH_KERNELS = ("haar_forward", "haar_inverse", "packed_forward",
                 "packed_inverse", "pyramid_forward", "compact")
BENCH_SMALL = ["--n", "16", "--reps", "1", "--iters", "1", "--large-n", "1",
               "--large-dim", "64"]


def run_measurement_programs() -> dict:
    """(m): the port's measurement programs on the card.  The device-stage
    bench (``python -m wavelet_tpu_torch.bench``'s main) at [128, 64^3]
    with 3 reps: one JSON line, every stage with a rep used and none
    implausible, K1-K5 and the compaction launched; its round-trip RMSE
    and kept fraction at n = 16 equal on cuda and cpu.  The scaling bench
    over [cuda:0, cuda:0] at [16, 64^3]; the e2e bench's cube64 on 32
    boxes of 64^3, its archives equal on cuda and cpu, and its global64
    (:func:`run_global64`); baseline config 6 on 16 boxes."""
    import torch

    from wavelet_tpu_torch import bench
    from wavelet_tpu_torch.scripts import (bench_e2e, measure_baseline,
                                           scaling_bench)

    out = {}
    _reset_launches()
    t0 = time.perf_counter()
    rc, lines = _quiet(bench.main, ["--reps", "3"])
    launches = _launches()
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"(m) bench printed {lines!r}, exit {rc}")
    r = json.loads(lines[0])
    ex = r["extra"]
    for k in BENCH_STAGES:
        if ex[k]["reps_used"] < 1 or ex[k].get("all_reps_implausible"):
            raise AssertionError(f"(m) bench stage {k}: {ex[k]}")
    for k in ("fused_spread", "plain_spread"):
        if ex["large_box_128"][k]["reps_used"] < 1:
            raise AssertionError(f"(m) bench large box: {ex['large_box_128']}")
    _check_counts("m, bench", launches, dict.fromkeys(BENCH_KERNELS, 1))
    if ex.pop("launches") != launches:
        raise AssertionError(f"(m) bench reports launches {r}, the "
                             f"counters {launches}")
    if ex["platform"] != torch.cuda.get_device_name(0) or not ex["name"]:
        raise AssertionError(f"(m) bench platform {ex['platform']!r}")
    out["bench"] = {"s": time.perf_counter() - t0, "line": r,
                    "launches": launches}
    quality = {}
    for dev in ("cuda", "cpu"):
        _reset_launches()
        rc, lines = _quiet(bench.main, ["--device", dev, *BENCH_SMALL])
        q = json.loads(lines[-1])["extra"]
        quality[dev] = {k: q[k] for k in ("roundtrip_rmse",
                                          "kept_coeff_fraction")}
        quality[f"{dev}_launches"] = _launches()
    if quality["cuda"] != quality["cpu"]:
        raise AssertionError(f"(m) bench quality {quality}")
    quality["launches"] = quality.pop("cuda_launches")
    _expect_launches("m, bench cpu", quality.pop("cpu_launches"), {})
    out["bench_quality_n16"] = quality

    _reset_launches()
    t0 = time.perf_counter()
    sc, _ = _quiet(scaling_bench.main, [
        "--repeat", "--devices", "2", "--dim", "64", "--per-device-boxes",
        "8", "--iters", "5", "--out", os.path.join(WORK, "scaling.json")])
    if sorted(sc["meshes"]) != ["1", "2"] or sc["distinct_devices"] != 1:
        raise AssertionError(f"(m) scaling {sc}")
    out["scaling"] = {"s": time.perf_counter() - t0,
                      "meshes": sc["meshes"], "launches": _launches()}

    e2e = {}
    for dev in ("cuda", "cpu"):
        _reset_launches()
        t0 = time.perf_counter()
        res, _ = _quiet(bench_e2e.main, [
            "--device", dev, "--root", WORK, "--out",
            os.path.join(WORK, f"e2e_{dev}.json"), "--configs", "cube64",
            "--boxes", "32", "--timesteps", "1", "--keep-files"])
        e2e[dev] = {"s": time.perf_counter() - t0, "row": res["cube64"],
                    "launches": _launches(), "run_dir": res["run_dir"]}
    for arch in ("arch_c", "arch_s"):
        # runinfo.raw names the dataset's directory, which differs, and
        # wtc-meta.json holds its checksum
        trees = [{k: v for k, v in _tree(os.path.join(
            e2e[dev]["run_dir"], "cube64", arch)).items()
            if k not in ("runinfo.raw", "wtc-meta.json")}
            for dev in ("cuda", "cpu")]
        if not any(k.endswith(".wtb") for k in trees[0]) or \
                trees[0] != trees[1]:
            raise AssertionError(f"(m) e2e {arch} differs on cuda and cpu")
    _expect_launches("m, e2e cpu", e2e["cpu"].pop("launches"), {})
    out["e2e"] = e2e
    out["e2e_global64"] = run_global64(bench_e2e)

    _reset_launches()
    t0 = time.perf_counter()
    mb, _ = _quiet(measure_baseline.main, [
        "--only", "6", "--scale", "0.25", "--work",
        os.path.join(WORK, "baseline"), "--out",
        os.path.join(WORK, "measured.json")])
    rows = mb["config6_e2e_sparse_regime"]
    if (rows["sparse"]["boxes"] != 16 or rows["sparse"]["host_to_device_bytes"]
            >= rows["dense"]["host_to_device_bytes"]):
        raise AssertionError(f"(m) baseline config 6 {rows}")
    out["baseline_config6"] = {"s": time.perf_counter() - t0, "rows": rows,
                               "launches": _launches()}
    return out


# (m)'s global64: box, global with the default globalcache, global with
# globalcache=0; the kernels each mode launches on the card (K1 alone, K6
# alone, K6 alone and twice as often: pass 2 transforms again)
GLOBAL64_ARGS = ["--configs", "global64", "--boxes", "32", "--timesteps",
                 "2", "--keep-files"]
GLOBAL64_KERNELS = {"box": "haar_forward", "global_cached": "forward_hist",
                    "global_uncached": "forward_hist"}


def run_global64(bench_e2e) -> dict:
    """(m)'s ``bench_e2e --configs global64`` on 2 timesteps of 32 boxes
    of 64^3, on cuda and on cpu, each mode's launches counted from 0 just
    before its ``compress_run`` and read just after: each mode's bundle
    equal on the two devices (but for the sidecars that name the
    dataset's directory), the global thresholds equal, the cache holding
    both timesteps with the default budget and none without, and each
    mode's kernels launched on the card alone (none on cpu)."""
    compress_mod = bench_e2e.compress_mod
    run = compress_mod.compress_run
    res = {}
    for dev in ("cuda", "cpu"):
        launches = []

        def counted(cfg, launches=launches):
            _reset_launches()
            stats = run(cfg)
            launches.append(_launches())
            return stats

        compress_mod.compress_run = counted
        t0 = time.perf_counter()
        try:
            r, _ = _quiet(bench_e2e.main, [
                "--device", dev, "--root", WORK, "--out",
                os.path.join(WORK, f"g64_{dev}.json"), *GLOBAL64_ARGS])
        finally:
            compress_mod.compress_run = run
        res[dev] = {"s": time.perf_counter() - t0, "row": r["global64"],
                    "launches": dict(zip(GLOBAL64_KERNELS, launches)),
                    "run_dir": r["run_dir"]}
    rows = [res[dev]["row"] for dev in ("cuda", "cpu")]
    for mode in GLOBAL64_KERNELS:
        trees = [{k: v for k, v in _tree(os.path.join(
            res[dev]["run_dir"], "global64", f"arch_{mode}")).items()
            if k not in ("runinfo.raw", "wtc-meta.json")}
            for dev in ("cuda", "cpu")]
        if sum(k.endswith(".wtb") for k in trees[0]) != 2 or \
                trees[0] != trees[1]:
            raise AssertionError(f"(m) global64 {mode}: bundles differ on "
                                 "cuda and cpu")
        thresholds = [row[mode]["global_threshold"] for row in rows]
        if thresholds[0] != thresholds[1]:
            raise AssertionError(f"(m) global64 {mode}: thresholds "
                                 f"{thresholds} on cuda and cpu")
    for row in rows:
        cached = [row[m]["cached_timesteps"] for m in GLOBAL64_KERNELS]
        if cached != [None, 2, 0]:
            raise AssertionError(f"(m) global64 cached timesteps {cached}")
    counts = res["cuda"]["launches"]
    for mode, kernel in GLOBAL64_KERNELS.items():
        _check_counts(f"m, global64 {mode}", counts[mode], {kernel: 1},
                      never=[k for k in KERNELS if k != kernel])
    if counts["global_uncached"]["forward_hist"] != \
            2 * counts["global_cached"]["forward_hist"]:
        raise AssertionError(f"(m) global64: uncached launches {counts}")
    for mode, n in res.pop("cpu")["launches"].items():
        _expect_launches(f"m, global64 cpu {mode}", n, {})
    return res


# (n): the host benches at small size.  The ragged run's --scale keeps all
# 44 shapes of both levels (the largest counts cut to a few boxes, ~13 MiB
# of f32 a timestep), and its twelve CLI calls run in this process: a
# fresh process took 7.7-10.5 s to import torch on one H100 host, which
# put (n) at 166 s.  The quality subset is the JAX script's 32 boxes, the
# at-scale run four
RAGGED_SCALE = "0.01"
QUALITY_BOXES = "32"
FUZZ_TRIALS = 50
RAGGED_ROWS = ("compress_cold", "compress_warm", "decompress_cold",
               "decompress_warm")


def _ragged(layout: str) -> dict:
    """(n): ``bench_ragged`` on one layout with ``--compare-cpu`` (every CLI
    call in this process): the card's archive and plotfiles equal the
    ``device=cpu`` run's, and each -c / -d row launched the route's
    kernels on every bucket of both timesteps (K1/K2 on ``auto``; K3/K4 on
    every bucket ``halves`` packs, K1/K2 on the others)."""
    from wavelet_tpu_torch.scripts import bench_ragged

    path = os.path.join(WORK, f"ragged_{layout}.json")
    t0 = time.perf_counter()
    rc, _ = _quiet(bench_ragged.main, [
        "--scale", RAGGED_SCALE, "--layout", layout, "--in-process",
        "--root", WORK, "--out", path])
    secs = time.perf_counter() - t0
    with open(path) as f:
        r = json.load(f)
    cmp = r["compare_cpu"]
    if rc != 0 or not (cmp["archive"]["identical"]
                       and cmp["plotfiles"]["identical"]):
        raise AssertionError(f"(n) ragged {layout}: exit {rc}, {cmp}")
    n_t = r["timesteps"]
    packed = r["buckets"]["packed"] * n_t
    plain = r["buckets"]["per_timestep"] * n_t - packed
    if r["n_shapes"] != 44 or (layout == "halves") != (packed > 0):
        raise AssertionError(f"(n) ragged {layout}: buckets {r['buckets']}")
    fwd, inv = (("packed_forward", "haar_forward"),
                ("packed_inverse", "haar_inverse"))
    for row in RAGGED_ROWS:
        k_packed, k_plain = fwd if row.startswith("compress") else inv
        _check_counts(f"n, ragged {layout} {row}", r[row]["launches"],
                      {k_packed: packed, k_plain: plain})
    return {"s": secs, "input_bytes": r["input_bytes"],
            "buckets": r["buckets"],
            "route_slot_waste": r["route_padding"]["slot_waste_fraction"],
            "compare_cpu": cmp,
            **{row: {k: r[row][k] for k in ("wall_seconds", "cli_seconds",
                                            "library_built", "launches")}
               for row in RAGGED_ROWS}}


def run_host_benches(kind: str) -> dict:
    """(n): the host benches on the card at small size.  ``bench_ragged``
    on both layouts (:func:`_ragged`); ``bench_quality`` at 32 boxes, the
    card's metrics equal to the CPU's; ``fuzz_campaign`` at 50 trials a
    surface with no backend disagreement; ``bench_host_codec`` and
    ``bench_plotfile_io`` at small sizes, each JSON naming this card and
    the host codec's device rate measured on it."""
    from wavelet_tpu_torch.scripts import (bench_host_codec,
                                           bench_plotfile_io, bench_quality,
                                           fuzz_campaign)

    out = {f"ragged_{layout}": _ragged(layout)
           for layout in ("auto", "halves")}
    runs = {
        "quality": (bench_quality, ["--n-boxes", "4",
                                    "--subset-boxes", QUALITY_BOXES]),
        "fuzz": (fuzz_campaign, ["--trials-per", str(FUZZ_TRIALS)]),
        "host_codec": (bench_host_codec, ["--n-items", "16", "--dim", "32"]),
        "plotfile_io": (bench_plotfile_io, ["--n-scale", "0.0625"]),
    }
    res = {}
    for name, (mod, args) in runs.items():
        path = os.path.join(WORK, f"{name}.json")
        _reset_launches()
        t0 = time.perf_counter()
        rc, _ = _quiet(mod.main, [*args, "--root", WORK, "--out", path])
        out[name] = {"s": time.perf_counter() - t0, "launches": _launches()}
        with open(path) as f:
            res[name] = json.load(f)
        if rc != 0 or res[name]["card"]["name"] != kind:
            raise AssertionError(f"(n) {name}: exit {rc}, card "
                                 f"{res[name]['card']}")
    q = res["quality"]["subset_cuda_vs_cpu"]
    if not q["all_metrics_identical"]:
        raise AssertionError(f"(n) quality: cuda and cpu differ: {q}")
    _check_counts("n, quality", out["quality"]["launches"],
                  {"haar_forward": 1, "forward_hist": 1, "haar_inverse": 1})
    out["quality"]["box_keep_sweep"] = q["cuda"]["box_keep_sweep"]
    f = res["fuzz"]
    if f["backend_disagreements"] or f["total_mutations"] != FUZZ_TRIALS * 13:
        raise AssertionError(f"(n) fuzz: {f}")
    _check_counts("n, fuzz", out["fuzz"]["launches"], {"haar_forward": 1})
    out["fuzz"].update(surfaces=f["surfaces"], native=f["native"])
    an = res["host_codec"]["analysis"]
    if not (an["device_compress_gbps"] > 0
            and an["device_card"]["name"] == kind
            and res["host_codec"]["pipeline_e2e"]["device"] == "cuda:0"):
        raise AssertionError(f"(n) host codec: {an}")
    _check_counts("n, host codec", out["host_codec"]["launches"],
                  {"haar_forward": 1, "pyramid_forward": 1})
    out["host_codec"]["analysis"] = {
        k: an.get(k) for k in ("device_compress_gbps",
                               "device_scatter_stage_gbps",
                               "cores_to_match_device_rate",
                               "e2e_gbps_with_this_host")}
    out["host_codec"]["native"] = res["host_codec"]["native"]
    for name, case in res["plotfile_io"]["cases"].items():
        if case["read_f32"]["f32_bytes"] != case["write_f32"]["src_bytes"]:
            raise AssertionError(f"(n) plotfile io {name}: {case}")
    out["plotfile_io"]["cases"] = sorted(res["plotfile_io"]["cases"])
    return out


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


def _haar_timing(device) -> dict:
    """K1, K2 and the pyramid kernels at :data:`TIME_SHAPE` (pyramids at
    :data:`TIME_SCALES`): kernel and plain times, bounds."""
    import numpy as np
    import torch

    from wavelet_tpu_torch.kernels import haar_cuda, pyramid_cuda

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
    return out


def _bench_compact_rows(device):
    """``python -m wavelet_tpu_torch.bench``'s compaction input: [128,
    64^3] N(0, 1) rows at its threshold (~0.93% kept) and the cap it
    passes (``bench.stages``: 1.5x that fraction, rounded up to 128
    slots)."""
    import numpy as np
    import torch

    from wavelet_tpu_torch import bench

    n, m = 128, 64 ** 3
    rng = np.random.default_rng(7)
    flat = torch.from_numpy(rng.standard_normal((n, m), np.float32)).to(
        device)
    t32 = torch.full((n,), bench.COMPACT_THRESHOLD, dtype=torch.float32,
                     device=device)
    return flat, t32, int(np.ceil(1.5 * 0.0093 * m / 128) * 128)


def _compact_bare(flat, t32, cap):
    """The kernel through the C interface on buffers allocated once: ->
    (the scratch's memset and the one launch, the memset alone), or None
    for a library without ``wt_compact`` (an older tree's two-kernel
    compaction, when this script is run against it)."""
    import torch

    from wavelet_tpu_torch.kernels import build
    from wavelet_tpu_torch.kernels.haar_cuda import _raise_if, _stream

    lib = build.library()
    if not hasattr(lib, "wt_compact"):
        return None
    n, m = (int(d) for d in flat.shape)
    dev = flat.device
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    idx = torch.empty((n, cap), dtype=torch.int32, device=dev)
    vals = torch.empty((n, cap), dtype=torch.float32, device=dev)
    scratch = torch.empty(int(lib.wt_compact_scratch(n, m)),
                          dtype=torch.int64, device=dev)
    st = _stream(flat)

    def memset(_):
        scratch.zero_()

    def launch(_):
        scratch.zero_()
        _raise_if(lib.wt_compact(flat.data_ptr(), t32.data_ptr(),
                                 counts.data_ptr(), idx.data_ptr(),
                                 vals.data_ptr(), scratch.data_ptr(), n, m,
                                 cap, st), lib, "compact")

    return launch, memset


def _compact_timing(device, rows) -> dict:
    """The compaction at the main path's rows (``rows`` =
    :func:`main_path_rows`) and at bench's ~0.93% kept
    (:func:`_bench_compact_rows`): in turns plain, bare, whole, whole,
    bare, plain, where "whole" is the wrapper the engine calls and "bare"
    the launch and its memset on preallocated buffers
    (:func:`_compact_bare`); then ``torch.nonzero`` (positions only) as the
    library yardstick.  The function's bound: one read of flat and t32,
    the pairs written (8 bytes each, up to the cap) and the counts."""
    import torch

    from wavelet_tpu_torch.kernels import compact_cuda

    out = {}
    for name, (flat, t32, cap) in (("main_path", rows[:3]),
                                   ("bench", _bench_compact_rows(device))):
        n, m = (int(d) for d in flat.shape)
        counts = (flat.abs() > t32[:, None]).sum(dim=1)
        written = int(counts.clamp(max=cap).sum())

        def whole(_):
            return compact_cuda.compact(flat, t32, cap)

        def plain(_):
            return compact_cuda.compact_plain(flat, t32, cap)

        bare = _compact_bare(flat, t32, cap)
        runs = [plain, whole, whole, plain] if bare is None else \
            [plain, bare[0], whole, whole, bare[0], plain]
        t = [_time_ms(fn, None) for fn in runs]
        res = {"shape": [n, m], "cap": cap, "kept": int(counts.sum()),
               "kept_fraction": float(counts.sum()) / (n * m),
               "max_row_kept_fraction": float(counts.max()) / m,
               "pairs_written": written,
               **_bound(n * m * 4 + 8 * n + 8 * written),
               "plain_ms": (t[0] + t[-1]) / 2, "runs_ms": t}
        res["ms"] = (t[1] + t[2]) / 2 if bare is None else (t[2] + t[3]) / 2
        if bare is not None:
            res["bare_ms"] = (t[1] + t[4]) / 2
            res["memset_ms"] = _time_ms(bare[1], None)
        res["library_ms"] = _time_ms(
            lambda _: torch.nonzero(flat.abs() > t32[:, None]), None)
        res["share"] = res["bound_ms"] / res["ms"]
        res["stage_gbps"] = n * m * 4 / 1e9 / (res["ms"] / 1e3)
        out[name] = res
    return out


def _hist_timing(device) -> dict:
    """``forward_hist`` (K6, scales=2) at :data:`TIME_SHAPE` and
    ``packed_forward_hist`` (K3 + histogram) on the same boxes packed two
    to a row, on N(0, 1), constant and ramp boxes: each held exactly
    against its plain version, then timed; bound and share.  A constant
    box has zero details, so nearly every coefficient lands in one bin of
    the histogram; a ramp's details are a few constants a box."""
    import numpy as np
    import torch

    from wavelet_tpu_torch.kernels import packed_cuda, pyramid_cuda

    rng = np.random.default_rng(8)
    n, X, Y, Z = TIME_SHAPE
    a = rng.standard_normal(n).astype(np.float32)[:, None, None, None]
    b = rng.standard_normal(n).astype(np.float32)[:, None, None, None]
    g = np.arange(X, dtype=np.float32)
    ramp = (g[:, None, None] + 2 * g[None, :, None]
            + 3 * g[None, None, :]) / np.float32(X)
    inputs = {"normal": rng.standard_normal(TIME_SHAPE, np.float32),
              "constant": np.broadcast_to(a, TIME_SHAPE),
              "ramp": a * ramp[None] + b}
    bound = _bound(2 * n * X * Y * Z * 4 + 2048 * 8)
    out = {}
    for kind, boxes in inputs.items():
        x = torch.from_numpy(np.ascontiguousarray(boxes, np.float32)).to(
            device)
        xp = torch.from_numpy(np.ascontiguousarray(
            boxes.reshape(n // 2, 2, X, Y, Z).transpose(0, 2, 3, 1, 4)
            .reshape(n // 2, X, Y, 2 * Z), np.float32)).to(device)
        for name, kern, plain, inp in (
                ("forward_hist",
                 lambda v: pyramid_cuda.forward_hist(v, TIME_SCALES),
                 lambda v: pyramid_cuda.forward_hist_plain(v, TIME_SCALES),
                 x),
                ("packed_forward_hist",
                 lambda v: packed_cuda.packed_forward_hist(v, 2),
                 lambda v: packed_cuda.packed_forward_hist_plain(v, 2),
                 xp)):
            c, hist = kern(inp)
            pc, phist = plain(inp)
            torch.cuda.synchronize()
            if not (_bits_equal(c, pc) and bool((hist == phist).all())):
                raise AssertionError(f"{name} on {kind} boxes != plain")
            ms = _time_ms(kern, inp)
            out.setdefault(name, {})[kind] = {
                "ms": ms, "share": bound["bound_ms"] / ms,
                "top_bin_fraction": float(hist.max()) / float(hist.sum())}
    for name in out:
        out[name].update(bound)
    return out


def phase_timing(device, rows) -> dict:
    """Kernel, plain-version and library times; each kernel's bound; the
    link; the sparse-transfer stages.  ``rows`` = :func:`main_path_rows`."""
    import torch

    from wavelet_tpu_torch.kernels import compact_cuda, haar_cuda
    from wavelet_tpu_torch.runtime import engine

    out = _haar_timing(device)
    comp = _compact_timing(device, rows)
    main = comp["main_path"]
    # the kernels line's row: the launch (with its scratch memset) on
    # preallocated buffers beside the whole plain compaction
    out["compact"] = {"ms": main["bare_ms"], "plain_ms": main["plain_ms"],
                      **{k: main[k] for k in ("bound_ms", "bound_by",
                                              "bound_bytes", "library_ms")}}
    # the whole compaction (the wrapper) is the compress side's sparse
    # stage: its rate is the d2h breakeven
    out["compaction"] = comp
    flat, t32, _, counts = rows
    n, m = (int(d) for d in flat.shape)
    dense_gb = n * m * 4 / 1e9
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


def _bare_launches(x, c):
    """K1 and K2 through the C interface on buffers allocated once: what
    the card takes without the wrappers' checks and allocations."""
    import torch

    from wavelet_tpu_torch.kernels import build
    from wavelet_tpu_torch.kernels.haar_cuda import _raise_if, _stream

    lib = build.library()
    n, X, Y, Z = (int(d) for d in x.shape)
    n_part = int(lib.wt_pyramid_forward_parts(X, Y, Z, 1))
    c2, out = torch.empty_like(x), torch.empty_like(x)
    ext = torch.empty((2, n), dtype=x.dtype, device=x.device)
    part = torch.empty((2, n, n_part), dtype=x.dtype, device=x.device)
    st = _stream(x)

    def forward(_):
        _raise_if(lib.wt_pyramid_forward(
            x.data_ptr(), c2.data_ptr(), ext[0].data_ptr(), ext[1].data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), None, n, X, Y, Z, 1, st),
            lib, "haar_forward")

    def inverse(_):
        _raise_if(lib.wt_pyramid_inverse(c.data_ptr(), out.data_ptr(), None,
                                         n, X, Y, Z, 1, st),
                  lib, "haar_inverse")

    return {"haar_forward": forward, "haar_inverse": inverse}


def phase_sweep(device) -> list:
    """K1 and K2 over :data:`SWEEP_SHAPES`: each held bitwise against its
    plain version (extrema up to the sign of a zero), then timed through
    its wrapper (``ms``) and bare (``bare_ms``, :func:`_bare_launches`);
    bound = (each input read once + each output written once) / 3.35 TB/s,
    the 8 bytes of a box's max and min included for K1."""
    import math

    import numpy as np
    import torch

    from wavelet_tpu_torch.kernels import haar_cuda

    rng = np.random.default_rng(6)
    base = torch.from_numpy(rng.standard_normal(SWEEP_FLOATS, np.float32)).to(
        device)
    rows = []
    for shape in SWEEP_SHAPES:
        x = base[:math.prod(shape)].view(shape)
        c, mx, mn = haar_cuda.fused_forward(x)
        pc, pmx, pmn = haar_cuda.fused_forward_plain(x)
        out = haar_cuda.fused_inverse(c)
        pout = haar_cuda.fused_inverse_plain(c)
        torch.cuda.synchronize()
        if not (_bits_equal(c, pc) and _bits_equal(mx, pmx, True)
                and _bits_equal(mn, pmn, True) and _bits_equal(out, pout)):
            raise AssertionError(f"sweep {list(shape)}: kernel != plain")
        del pc, pmx, pmn, out, pout
        row = {"shape": list(shape)}
        bare = _bare_launches(x, c)
        for name, fn, inp, extra in (
                ("haar_forward", haar_cuda.fused_forward, x, 8 * shape[0]),
                ("haar_inverse", haar_cuda.fused_inverse, c, 0)):
            ms = _time_ms(fn, inp)
            bound = (2 * 4 * x.numel() + extra) / HBM_BYTES_PER_S * 1e3
            row[name] = {"ms": ms, "bound_ms": bound, "share": bound / ms,
                         "bare_ms": _time_ms(bare[name], None)}
        rows.append(row)
    return rows


def kernels_only(device, card: str) -> int:
    """``--kernels``: build, phase 4's Haar, lane-packed and compaction
    checks, the K1/K2 sweep, K3/K4 at P = 64 beside K1/K2, K1-K7 at
    :data:`TIME_SHAPE`, the compaction at the main path's rows (the
    dataset is written for them alone) and at bench's, and the histogram
    passes on constant and ramp boxes; no end-to-end path, no result
    line."""
    from wavelet_tpu_torch.kernels import build

    build.library()
    print(f"build: {build.build_seconds:.2f} s")
    print(build.build_log.strip())
    shutil.rmtree(WORK, ignore_errors=True)
    data_dir = os.path.join(WORK, "data")
    make_dataset(data_dir)
    rows = main_path_rows(data_dir, device)
    shutil.rmtree(WORK, ignore_errors=True)
    err = {**phase_kernels(device), **phase_pyramid_kernels(device),
           **phase_packed_kernels(device),
           **phase_compact_kernels(
               _compact_edge_cases(device)
               + [(f"main path [{TIME_SHAPE[0]}, {rows[0].shape[1]}] "
                   f"cap={rows[2]}", *rows[:3])])}
    print(f"phase 4 ok (max_abs_err {err})")
    print(f"K1/K2 box-size sweep ({card}): "
          + json.dumps(phase_sweep(device)))
    print(f"K3/K4 at P = 64 beside K1/K2 ({card}): "
          + json.dumps(_packed_timing(device)["p64"]))
    print(f"K1, K2 at {list(TIME_SHAPE)}, K5-K7 at scales={TIME_SCALES} "
          f"({card}): " + json.dumps(_haar_timing(device)))
    print(f"compaction ({card}): "
          + json.dumps(_compact_timing(device, rows)))
    print(f"histogram passes on normal, constant and ramp boxes ({card}): "
          + json.dumps(_hist_timing(device)))
    return 0


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
    if sys.argv[1:] == ["--kernels"]:
        return kernels_only(device, card)

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
    for name, what, run in (
            ("h", "-d preview=1|2 of (a) and (b)", lambda: run_previews(done)),
            ("i", "first timestep of (a) and (c) over a two-entry mesh",
             lambda: run_mesh(data_dir)),
            ("j", f"one {GIANT_N}^3 box split along X, scales=1|2, then "
                  "preview=2", run_giant),
            ("k", "two processes on one card: -c (a), -c (c) bundle, -d "
                  f"(a); giantmesh=global with a {GLOBAL_N}^3 box",
             lambda: run_two_processes(data_dir)),
            ("l", "the collective steps over a two-entry mesh against eight "
                  "CPU entries; dryrun_multichip(2)",
             lambda: run_steps(data_dir))):
        t0 = time.perf_counter()
        res = run()
        secs = time.perf_counter() - t0
        for counts in _launch_dicts(res):
            for k, v in counts.items():
                launches[k] += v
        print(f"wall ({name}): {secs:.1f} s")
        print(f"end to end ({name}, {what}; {card}; {secs:.1f} s): "
              + json.dumps(res))
    # (m)'s launches follow its timing loops' reps and iterations: they are
    # checked in (m) itself and left out of the kernels line, but for
    # global64's, which come from its three compress_run calls alone
    t0 = time.perf_counter()
    res = run_measurement_programs()
    secs = time.perf_counter() - t0
    for counts in res["e2e_global64"]["cuda"]["launches"].values():
        for k, v in counts.items():
            launches[k] += v
    print(f"wall (m): {secs:.1f} s")
    print(f"end to end (m, the measurement programs: bench at [128, 64^3], "
          f"scaling over [cuda:0, cuda:0], e2e cube64 on 32 boxes and "
          f"global64 on 2 x 32 boxes in its three modes, baseline config "
          f"6; {card}; {secs:.1f} s): " + json.dumps(res))
    # (n)'s launches, like those of (m)'s timed runs, are checked in (n)
    # and left out of the kernels line
    t0 = time.perf_counter()
    res = run_host_benches(kind)
    secs = time.perf_counter() - t0
    print(f"wall (n): {secs:.1f} s")
    print(f"end to end (n, the host benches: ragged at --scale "
          f"{RAGGED_SCALE} on both layouts against device=cpu, quality at "
          f"{QUALITY_BOXES} boxes, fuzz at {FUZZ_TRIALS} trials, host codec, "
          f"plotfile I/O; {card}; {secs:.1f} s): " + json.dumps(res))
    timing = phase_timing(device, rows)
    timing["histogram_passes"] = _hist_timing(device)
    shutil.rmtree(WORK, ignore_errors=True)
    print(f"kernel times at {list(TIME_SHAPE)}, pyramids at scales="
          f"{TIME_SCALES}, compaction on the main path's and bench's rows "
          f"({card}): " + json.dumps(timing))
    print(f"K1/K2 box-size sweep ({card}): "
          + json.dumps(phase_sweep(device)))
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
