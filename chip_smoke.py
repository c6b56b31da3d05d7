#!/usr/bin/env python3
"""End-to-end smoke check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # one card

Phases (any failure exits non-zero before the last line):

1. ``torch.cuda.is_available()`` must hold: there is no CPU fallback.
2. Print the card's name and power limit (nvidia-smi).
3. Build the CUDA kernels from ``wavelet_tpu_torch/csrc`` with nvcc.
4. Each kernel against its plain PyTorch version on the card, bitwise
   (int32 views) on coefficients, per-box max and min: the main path's
   shapes, odd shapes, subnormals, an exact ``min == -max`` tie and a box
   holding NaN; then the inverse on the same shapes.  One exception: a
   zero extremum may come back as +0.0 from one and -0.0 from the other.
   The sign of a zero extremum cannot change ``|c| > t32`` (the threshold
   is then +-0 and no magnitude is below zero), so it cannot change an
   archive byte.
5. End to end: a synthetic AMR run (2 timesteps, 2 levels, 4 components,
   ~168 MiB of f32 boxes per timestep, f64 FABs on disk) compressed and
   decompressed through ``wavelet_tpu_torch.cli`` with ``device=cuda``;
   the regenerated plotfiles must be byte-identical to the same run with
   ``device=cpu`` (the plain path, which the CPU tests hold bitwise to the
   JAX package), both kernels must have been launched, and the output
   must be finite and close to the input.  Kernel and plain-version times
   are taken with CUDA events at the main path's 64^3 batch.

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

    from wavelet_tpu.io import plotfile

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


def _run_cli(args) -> float:
    from wavelet_tpu_torch import cli

    t0 = time.perf_counter()
    rc = cli.main(args)
    dt = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"wavelet_tpu_torch.cli {args} exited {rc}")
    return dt


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            p = os.path.join(dirpath, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def phase_end_to_end(data_dir: str, nbytes: int) -> dict:
    """Phase 5: -c/-d through the CLI on cuda and cpu; returns timings and
    the kernels' launch counts from the cuda run."""
    import numpy as np

    from wavelet_tpu import native
    from wavelet_tpu.io import plotfile
    from wavelet_tpu_torch.kernels import haar_cuda

    res = {}
    for dev in ("cuda", "cpu"):
        comp = os.path.join(WORK, f"arch_{dev}") + os.sep
        out = os.path.join(WORK, f"out_{dev}") + os.sep
        c_args = [f"datadir={data_dir}", f"minfile={TIMESTEPS[0]}",
                  f"maxfile={TIMESTEPS[-1]}", "minlevel=0", "maxlevel=1",
                  "components=" + " ".join(COMPONENTS), f"keep={KEEP}",
                  f"compresseddir={comp}", f"device={dev}", "-c"]
        d_args = [f"compresseddir={comp}", f"out={out}", f"device={dev}",
                  "-d"]
        if dev == "cuda":
            haar_cuda.reset_launches()
        res[f"{dev}_compress_s"] = _run_cli(c_args)
        res[f"{dev}_decompress_s"] = _run_cli(d_args)
        if dev == "cuda":
            res["launches"] = dict(haar_cuda.launches)
    for k, v in res["launches"].items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main "
                                 f"path ({res['launches']})")
    archives = [_tree(os.path.join(WORK, f"arch_{d}")) for d in ("cuda",
                                                               "cpu")]
    if archives[0] != archives[1]:
        raise AssertionError("archives differ between device=cuda and cpu")
    trees = [_tree(os.path.join(WORK, f"out_{d}")) for d in ("cuda", "cpu")]
    if trees[0] != trees[1] or not trees[0]:
        raise AssertionError("plotfiles differ between device=cuda and cpu")
    res["archive_bytes"] = sum(len(b) for b in archives[0].values())
    res["plotfile_files"] = len(trees[0])
    # the output is the input up to the lossy threshold: finite, same
    # geometry, small error relative to the field's range
    worst = 0.0
    for name in TIMESTEPS:
        for lev in (0, 1):
            a = plotfile.read_level(os.path.join(data_dir, name), lev,
                                    range(len(COMPONENTS)))
            b = plotfile.read_level(os.path.join(WORK, "out_cuda", name),
                                    lev, range(len(COMPONENTS)))
            assert a.dimensions == b.dimensions
            for xa, xb in zip(a.boxes, b.boxes):
                assert np.isfinite(xb).all() and xa.shape == xb.shape
                rng_ = float(xa.max() - xa.min()) or 1.0
                worst = max(worst, float(np.abs(xa - xb).max()) / rng_)
    if worst > 0.01:
        raise AssertionError(f"reconstruction error {worst} of the range")
    res["max_rel_err"] = worst
    res["native_codec"] = bool(native.available())
    # where the time goes: the same cuda run once more through the API,
    # which returns the pipelines' per-stage seconds
    import wavelet_tpu_torch

    cs = wavelet_tpu_torch.compress(
        data_dir, os.path.join(WORK, "arch_stages"), min_time=TIMESTEPS[0],
        max_time=TIMESTEPS[-1], components=COMPONENTS, min_level=0,
        max_level=1, keep=KEEP, device="cuda")
    ds = wavelet_tpu_torch.decompress(
        os.path.join(WORK, "arch_stages"), os.path.join(WORK, "out_stages"),
        device="cuda")
    res["stages"] = {
        "compress": {k: cs[k] for k in ("compress_seconds", "read_seconds",
                                        "device_seconds",
                                        "pack_wait_seconds")},
        "decompress": {k: ds[k] for k in ("decompress_seconds",
                                          "unpack_seconds", "device_seconds",
                                          "write_seconds")}}
    res["gbps"] = {k: nbytes / 1e9 / res[f"{k}_s"]
                   for k in ("cuda_compress", "cuda_decompress",
                             "cpu_compress", "cpu_decompress")}
    return res


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


def phase_timing(device) -> dict:
    import numpy as np
    import torch

    from wavelet_tpu_torch.kernels import haar_cuda

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(TIME_SHAPE, np.float32)).to(
        device)
    c = haar_cuda.fused_forward(x)[0]
    pairs = {"haar_forward": (haar_cuda.fused_forward,
                              haar_cuda.fused_forward_plain, x),
             "haar_inverse": (haar_cuda.fused_inverse,
                              haar_cuda.fused_inverse_plain, c)}
    out = {}
    for name, (kern, plain, inp) in pairs.items():
        # plain, kernel, kernel, plain: report the mean of each pair
        p1 = _time_ms(plain, inp)
        k1 = _time_ms(kern, inp)
        k2 = _time_ms(kern, inp)
        p2 = _time_ms(plain, inp)
        out[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                     "runs_ms": [p1, k1, k2, p2]}
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

    err = phase_kernels(device)
    print(f"phase 4 ok: kernels bitwise equal to plain versions "
          f"(max_abs_err {err})")
    shutil.rmtree(WORK, ignore_errors=True)
    data_dir = os.path.join(WORK, "data")
    t0 = time.perf_counter()
    nbytes = make_dataset(data_dir)
    print(f"dataset: {nbytes} f32 box bytes in {len(TIMESTEPS)} "
          f"timesteps, written in {time.perf_counter() - t0:.1f} s")
    e2e = phase_end_to_end(data_dir, nbytes)
    timing = phase_timing(device)
    shutil.rmtree(WORK, ignore_errors=True)
    print(f"end to end ({card}): " + json.dumps(e2e))
    print(f"kernel times at {list(TIME_SHAPE)} ({card}): " +
          json.dumps(timing))
    kernels = []
    sources = {"haar_forward": "wavelet_tpu/kernels/haar_pallas.py:172",
               "haar_inverse": "wavelet_tpu/kernels/haar_pallas.py:202"}
    for name, replaces in sources.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "wavelet_tpu_torch/csrc/haar.cu",
            "replaces": replaces,
            "launches": e2e["launches"][name],
            "max_abs_err": err[name],
            "ms": timing[name]["ms"],
            "plain_ms": timing[name]["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
