"""Ragged-shape benchmark of the port: 44 distinct AMR box shapes end to end.

    python -m wavelet_tpu_torch.scripts.bench_ragged [--device cuda|cpu]
        [--layout auto|halves] [--scale 1.0] [--root DIR]
        [--no-compare-cpu] [--in-process] [--e2e PATH]
        [--out bench_results_torch/ragged_e2e.json]

The counterpart of the JAX package's ``scripts/bench_ragged.py``, with its
dataset byte for byte: 44 distinct shapes drawn from edges 8..128 (odd
ones 9, 17 and 33 included), Zipf-ish counts, two levels, two timesteps,
~550 MiB of f32 boxes a timestep (773 boxes; f64 FABs on disk).
``--scale F`` multiplies every shape's count (at least one box each), so
all 44 shapes and both levels stay.

``-c`` (``keep=0.999 codec=raw archive=bundle prefetch=1``) and then
``-d`` (``outprec=f32 prefetch=1``) each run twice, cold then warm, each
in a fresh process that calls :func:`wavelet_tpu_torch.cli.main` with the
CLI's arguments (what ``python -m wavelet_tpu_torch.cli`` runs) under
``WAVELET_TPU_LAYOUT=<layout>``, and reports its kernels' launch counts
(``--in-process``: every call in this process instead, so that no wall
carries an interpreter's start-up, which takes seconds where ``torch``
imports slowly).  The port compiles no kernel per shape; in place of the JAX script's jit
compile counts each row says whether the run built the kernel library
(``kernels/build.library_path()`` missing before it) and the seconds the
library's build or load took.  ``buckets`` counts the shape buckets of a
timestep and those the route lane-packs.

``padding`` is the JAX script's geometry (``lane_pack_factor`` and
``cap_pack`` on every shape: the halves route's); ``route_padding`` is the
geometry of the route that ran (``CodecEngine.pack_factor``: on ``auto``
every shape at pack=1, which pads nothing).

``--compare-cpu`` (the default on a card) runs the same ``-c`` and ``-d``
with ``device=cpu``: the archive and the regenerated plotfiles must be
byte-identical to the card's, or the program exits 1.  ``--e2e PATH``
puts the GB/s of a ``scripts.bench_e2e`` artifact's uniform-shape rows
beside this run's (opt-in: nothing is read otherwise).

The run works in a directory of its own made under ``--root`` (default:
the temporary directory) and removes it at the end; nothing else under
``--root`` is touched.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

from wavelet_tpu_torch import bench
from wavelet_tpu_torch.io import plotfile as pf
from wavelet_tpu_torch.kernels import build, packed_cuda
from wavelet_tpu_torch.runtime import batching, engine
from wavelet_tpu_torch.scripts import harness

__all__ = ["DIM_CHOICES", "build_shapes", "scale_shapes", "spiky",
           "write_dataset", "padding_stats", "route_geometry", "main"]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join("bench_results_torch", "ragged_e2e.json")
_CHILD = "--cli-child"
_LAYOUT = "WAVELET_TPU_LAYOUT"

DIM_CHOICES = [8, 9, 12, 16, 17, 20, 24, 32, 33, 40, 48, 64, 80, 96, 128]


def build_shapes(n_shapes=44, target_bytes_per_t=550 << 20, seed=7):
    """[(dims, count, level)] — Zipf-ish counts over randomly drawn ragged
    shapes (odd dims included), the largest shapes topped up so one
    timestep carries ~target bytes."""
    rng = np.random.default_rng(seed)
    shapes = []
    seen = set()
    while len(shapes) < n_shapes:
        d = tuple(int(v) for v in rng.choice(DIM_CHOICES, 3))
        if d not in seen:
            seen.add(d)
            shapes.append(d)
    counts = [max(1, round(120 / (r + 1))) for r in range(n_shapes)]
    rng.shuffle(counts)                      # counts not correlated to size
    vols = [int(np.prod(s)) for s in shapes]
    total = sum(c * v * 4 for c, v in zip(counts, vols))
    # top up with the largest shapes until the byte target is met
    order = np.argsort(vols)[::-1]
    i = 0
    while total < target_bytes_per_t:
        j = int(order[i % 4])
        counts[j] += 1
        total += vols[j] * 4
        i += 1
    return [(shapes[i], counts[i], i % 2) for i in range(n_shapes)], total


def scale_shapes(shapes, scale: float):
    """-> (shapes with every count times ``scale``, at least 1; the f32
    bytes of a timestep): every shape and both levels stay."""
    out = [(dims, max(1, round(count * scale)), lev)
           for dims, count, lev in shapes]
    return out, sum(c * int(np.prod(d)) * 4 for d, c, _lev in out)


def spiky(shape, n, rng):
    """~1%-kept boxes, vectorized per shape bucket."""
    a = (rng.standard_normal((n,) + shape).astype(np.float32)) * 1e-3
    mask = rng.random((n,) + shape) < 0.0125
    a[mask] = np.abs(rng.standard_normal(int(mask.sum()))
                     ).astype(np.float32) * 100
    return a


def write_dataset(root, shapes, n_times=2, seed=100):
    for t in range(n_times):
        rng = np.random.default_rng(seed + t)
        per_level = {0: ([], [], []), 1: ([], [], [])}
        xoff = {0: 0, 1: 0}
        for dims, count, lev in shapes:
            boxes = spiky(dims, count, rng)
            bl, ll, dl = per_level[lev]
            for b in range(count):
                bl.append(boxes[b][None])          # 1 component
                ll.append((xoff[lev], 0, 0))
                dl.append(dims)
                xoff[lev] += dims[0]
        # level-1 domain is base*2, so base x must cover both layouts
        dom_x = max(1, xoff[0], -(-xoff[1] // 2))
        pf.write_plotfile(
            os.path.join(root, f"plt{800 + t:05d}"),
            [per_level[0][0], per_level[1][0]],
            [per_level[0][1], per_level[1][1]],
            [per_level[0][2], per_level[1][2]],
            ["f"], 0.1 * t, [0., 0., 0.], [1., 1., 1.], (2, 2, 2),
            (dom_x, 128, 128), [t, 2 * t])


def padding_stats(shapes, pack_fn=packed_cuda.lane_pack_factor):
    """Padding-waste of the REAL batch plan: slots and bytes added by
    cap_pack lane packing (no mesh here, pad_multiple=1 — single chip).
    ``pack_fn(dims)`` is the lane-pack factor before ``cap_pack`` (default:
    the halves route's, as the JAX script computes it)."""
    real_slots = 0
    padded_slots = 0
    real_bytes = 0
    padded_bytes = 0
    per_shape = {}
    for dims, count, _lev in shapes:
        pack = pack_fn(dims)
        pack = batching.cap_pack(pack, count, dims[-1])
        n_pad = batching.pad_to_multiple(count, pack) if pack > 1 else count
        vol = int(np.prod(dims)) * 4
        real_slots += count
        padded_slots += n_pad
        real_bytes += count * vol
        padded_bytes += n_pad * vol
        per_shape[str(dims)] = {"count": count, "pack": pack,
                                "padded_to": n_pad}
    return {"real_slots": real_slots, "padded_slots": padded_slots,
            "slot_waste_fraction": round(padded_slots / real_slots - 1, 4),
            "real_bytes": real_bytes, "padded_bytes": padded_bytes,
            "byte_waste_fraction": round(padded_bytes / real_bytes - 1, 4),
            "per_shape": per_shape}


def route_geometry(shapes, layout: str):
    """-> (the padding of the route ``layout`` runs, {"per_timestep": shape
    buckets of a timestep, "packed": those it lane-packs}), from the
    engine's own ``pack_factor``."""
    eng = engine.CodecEngine(device="cpu", layout=layout)
    pad = padding_stats(shapes, pack_fn=eng.pack_factor)
    packed = sum(1 for row in pad["per_shape"].values() if row["pack"] > 1)
    return pad, {"per_timestep": len(pad["per_shape"]), "packed": packed}


def cli_call(cli_args, layout: str) -> dict:
    """One CLI run in this process: ``cli.main(cli_args)`` under
    ``WAVELET_TPU_LAYOUT=layout`` (restored after).  -> its seconds, the
    kernels it launched, and the seconds it spent building or loading the
    kernel library (None: the library was loaded before, or not at all).
    Raises if the CLI fails."""
    from wavelet_tpu_torch import cli

    loaded = build.build_seconds is not None
    before = bench.kernel_launches()
    old = os.environ.get(_LAYOUT)
    os.environ[_LAYOUT] = layout
    try:
        t0 = time.perf_counter()
        rc = cli.main(cli_args)
        secs = time.perf_counter() - t0
    finally:
        if old is None:
            del os.environ[_LAYOUT]
        else:
            os.environ[_LAYOUT] = old
    if rc != 0:
        raise RuntimeError(f"CLI failed (exit {rc}): {' '.join(cli_args)}")
    after = bench.kernel_launches()
    return {"cli_seconds": secs,
            "launches": {k: after[k] - before[k] for k in after},
            "library_seconds": None if loaded else build.build_seconds}


def _cli_child(report: str, layout: str, cli_args) -> int:
    """A fresh process's one CLI run (:func:`cli_call`), its report
    written to ``report``."""
    rep = cli_call(cli_args, layout)
    with open(report, "w") as f:
        json.dump(rep, f)
    return 0


def run_cli(args, layout: str, work: str, tag: str,
            in_process: bool = False) -> dict:
    """``args`` through the CLI under ``WAVELET_TPU_LAYOUT=layout``: in a
    fresh process (:func:`_cli_child`, its output to ``work/<tag>.log``),
    or with ``in_process`` in this one.  -> the row: wall, the CLI's own
    seconds, whether the run built the kernel library, its build-or-load
    seconds, the launches."""
    lib = build.library_path()
    existed = os.path.exists(lib)
    t0 = time.perf_counter()
    if in_process:
        rep = cli_call(args, layout)
    else:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
        report = os.path.join(work, f"{tag}.json")
        log_path = os.path.join(work, f"{tag}.log")
        with open(log_path, "w") as log:
            r = subprocess.run(
                [sys.executable, "-m",
                 "wavelet_tpu_torch.scripts.bench_ragged", _CHILD, report,
                 layout, *args], cwd=REPO, env=env, stdout=log,
                stderr=subprocess.STDOUT)
        if r.returncode != 0:
            with open(log_path, errors="replace") as f:
                raise RuntimeError(f"CLI failed ({' '.join(args[-2:])}): "
                                   f"{f.read()[-2000:]}")
        with open(report) as f:
            rep = json.load(f)
    wall = time.perf_counter() - t0
    return {"wall_seconds": round(wall, 3),
            "cli_seconds": round(rep["cli_seconds"], 3),
            "library_built": not existed and os.path.exists(lib),
            "library_seconds": rep["library_seconds"],
            "launches": rep["launches"]}


def trees_identical(a: str, b: str) -> dict:
    """Byte-compare two directory trees: the same relative file names, each
    file's bytes equal."""
    def names(root):
        return sorted(os.path.relpath(os.path.join(d, n), root)
                      for d, _, ns in os.walk(root) for n in ns)

    na, nb = names(a), names(b)
    same = na == nb and all(filecmp.cmp(os.path.join(a, n),
                                        os.path.join(b, n), shallow=False)
                            for n in na)
    return {"files": len(na), "identical": same}


def _uniform_e2e(path):
    """GB/s of a ``bench_e2e`` artifact's rows, or None without a path."""
    if path is None:
        return None
    with open(path) as f:
        art = json.load(f)
    rows = {label: {v: art[label][v]["e2e_measured_gbps"]
                    for v in ("collected", "streaming",
                              "decompress_streaming")}
            for label in ("cube64", "cube128") if label in art}
    return {"artifact": path, "card": art.get("card"), **rows}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m wavelet_tpu_torch.scripts.bench_ragged",
        description="Ragged-shape end-to-end benchmark of "
                    "wavelet_tpu_torch (44 distinct box shapes).")
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--layout", default="auto", choices=("auto", "halves"),
                    help="WAVELET_TPU_LAYOUT of the CLI runs")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiplies every shape's box count (at least 1)")
    ap.add_argument("--root", default=None,
                    help="the directory under which this run makes its own "
                         "(default: the temporary directory)")
    ap.add_argument("--compare-cpu", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="also run -c and -d with device=cpu and require "
                         "byte-identical outputs (on a card; default on)")
    ap.add_argument("--in-process", action="store_true",
                    help="run each CLI call in this process instead of a "
                         "fresh one (no interpreter start-up in the walls)")
    ap.add_argument("--e2e", default=None, metavar="PATH",
                    help="a scripts.bench_e2e artifact whose GB/s to show "
                         "beside this run's (default: none)")
    ap.add_argument("--out", default=OUT)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == [_CHILD]:
        return _cli_child(argv[1], argv[2], argv[3:])
    a = parse_args(argv)
    dev, card = harness.device_card(a.device)
    shapes, bytes_per_t = scale_shapes(build_shapes()[0], a.scale)
    n_times = 2
    input_bytes = bytes_per_t * n_times
    route_pad, buckets = route_geometry(shapes, a.layout)
    out = {"timestamp": time.strftime("%Y-%m-%d %H:%M:%S"), "card": card,
           "device": dev.type, "layout": a.layout, "scale": a.scale,
           "in_process": a.in_process,
           "n_shapes": len(shapes), "timesteps": n_times,
           "input_bytes": input_bytes, "buckets": buckets,
           "note": ("cold = the first CLI call of this run (it builds the "
                    "kernel library if no earlier run left it); warm = the "
                    "same command again. Each call runs in a fresh process "
                    "unless in_process, and compiles nothing per shape: "
                    "one library serves every shape"),
           "padding": padding_stats(shapes), "route_padding": route_pad}
    print("padding:", json.dumps({k: v for k, v in out["padding"].items()
                                  if k != "per_shape"}), flush=True)
    compare = a.compare_cpu and dev.type == "cuda"
    with harness.private_dir(a.root, "wtc_ragged_") as run_dir:
        data = os.path.join(run_dir, "data")
        t0 = time.perf_counter()
        write_dataset(data, shapes, n_times)
        out["dataset_write_seconds"] = round(time.perf_counter() - t0, 3)
        print("dataset written", out["dataset_write_seconds"], "s",
              flush=True)

        def cargs(arch, device):
            return [f"datadir={data}", "minfile=plt00800",
                    f"maxfile=plt{800 + n_times - 1:05d}", "minlevel=0",
                    "maxlevel=1", "components=f", "keep=0.999", "codec=raw",
                    "archive=bundle", "prefetch=1",
                    f"compresseddir={arch}/", f"device={device}", "-c"]

        def dargs(arch, regen, device):
            return [f"compresseddir={arch}/", f"out={regen}/", "prefetch=1",
                    "outprec=f32", f"device={device}", "-d"]

        arch, regen = (os.path.join(run_dir, n) for n in ("arch", "regen"))
        for mode, args, target in (("compress", cargs(arch, dev.type), arch),
                                   ("decompress",
                                    dargs(arch, regen, dev.type), regen)):
            for phase in ("cold", "warm"):
                shutil.rmtree(target, ignore_errors=True)
                row = run_cli(args, a.layout, run_dir, f"{mode}_{phase}",
                              a.in_process)
                row["e2e_gbps"] = round(
                    input_bytes / 1e9 / row["wall_seconds"], 4)
                out[f"{mode}_{phase}"] = row
                print(f"{mode} {phase}:", json.dumps(row), flush=True)
        out["compare_cpu"] = None
        if compare:
            arch_c, regen_c = (os.path.join(run_dir, n)
                               for n in ("arch_cpu", "regen_cpu"))
            c = run_cli(cargs(arch_c, "cpu"), a.layout, run_dir,
                        "compress_cpu", a.in_process)
            d = run_cli(dargs(arch_c, regen_c, "cpu"), a.layout, run_dir,
                        "decompress_cpu", a.in_process)
            out["compare_cpu"] = {
                "compress_wall_seconds": c["wall_seconds"],
                "decompress_wall_seconds": d["wall_seconds"],
                "archive": trees_identical(arch, arch_c),
                "plotfiles": trees_identical(regen, regen_c)}
            print("compare cpu:", json.dumps(out["compare_cpu"]), flush=True)
    out["uniform_e2e"] = _uniform_e2e(a.e2e)
    harness.write_json(a.out, out)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("padding", "route_padding")}), flush=True)
    cmp = out["compare_cpu"]
    if cmp is not None and not (cmp["archive"]["identical"]
                                and cmp["plotfiles"]["identical"]):
        print("bench_ragged: the device=cpu outputs differ from the card's",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
