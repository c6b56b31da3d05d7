#!/usr/bin/env python3
"""Where the device time goes in ``chip_smoke.py``'s end-to-end runs.

    python3 profile_runs.py [--out chiprun_out/profile_runs.json]

Writes ``chip_smoke.py``'s synthetic dataset (both timesteps), then for
each of its configurations ((a)-(c) dense, (d) ``scales=2
transfer=sparse`` on ``-c`` and ``-d``, (e) (a) under
``WAVELET_TPU_LAYOUT=halves``, the lane-packed kernels) runs ``-c`` and
``-d`` with ``device=cuda`` once to warm up and once under
``torch.profiler``; then (h) ``-d preview=P`` of (a)'s and (b)'s archives,
(i) (a)'s ``-c`` and ``-d`` through the API over a two-entry mesh, and (j)
the 256^3 giant box's ``-c`` and ``-d`` at one scale over that mesh.  For
each run it
reports the wall seconds of the profiled run, the device busy time (the
union of the CUDA activity intervals: kernels, copies, memsets), the idle
share ``1 - busy / wall``, the device time and count of each activity by
name, and the pipeline's own per-stage stats.  The JSON goes to ``--out``;
a one-line summary per run goes to standard output.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import chip_smoke

WORK = os.path.join(chip_smoke.REPO, "build", "profile_runs")


def _device_busy(events):
    """-> (busy ms as the union of CUDA intervals, {name: [ms, count]})."""
    import torch

    spans, by_name = [], {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = [ms + (end - start) / 1e3, n + 1]
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3, dict(sorted(by_name.items(), key=lambda kv: -kv[1][0]))


def _profiled(run):
    """``run()`` (-> the pipeline's stats) once to warm up, then once under
    the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()                              # warm-up: build, allocator, caches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, by_name = _device_busy(prof.events())
    return {"wall_s": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / 1e3 / wall, "by_name_ms": by_name,
            "stats": stats}


def _cli(args):
    return lambda: chip_smoke._run_cli(args)[1]


def _api(report, name, data_dir, steps, mesh, c_opts, d_opts=None,
         components=chip_smoke.COMPONENTS, max_level=1):
    """``-c`` then ``-d`` through the API over ``mesh``, each profiled."""
    import wavelet_tpu_torch

    comp = os.path.join(WORK, f"{name}_arch") + os.sep
    out = os.path.join(WORK, f"{name}_out") + os.sep
    _report(report, f"{name}_compress", lambda: wavelet_tpu_torch.compress(
        data_dir, comp, min_time=steps[0], max_time=steps[-1],
        components=list(components), min_level=0, max_level=max_level,
        device="cuda", mesh=mesh, **c_opts))
    _report(report, f"{name}_decompress",
            lambda: wavelet_tpu_torch.decompress(
                comp, out, device="cuda", mesh=mesh, **(d_opts or {})))


def _report(report, name, run) -> None:
    r = report[name] = _profiled(run)
    print(f"{name}: wall {r['wall_s']:.3f} s, device busy "
          f"{r['device_busy_ms']:.1f} ms, idle share {r['idle_share']:.4f}")


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        chip_smoke.REPO, "chiprun_out", "profile_runs.json"))
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_runs: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    card = chip_smoke._card()
    print(f"card: {card}")
    shutil.rmtree(WORK, ignore_errors=True)
    data_dir = os.path.join(WORK, "data")
    chip_smoke.make_dataset(data_dir)
    steps = chip_smoke.TIMESTEPS
    report = {"card": card}
    for name, keys, d_keys, _steps, _expect, _bound, _same, *extra in \
            chip_smoke.CONFIGS:
        env = extra[0].get("env", {}) if extra else {}
        comp = os.path.join(WORK, f"{name}_arch") + os.sep
        out = os.path.join(WORK, f"{name}_out") + os.sep
        c_args = [f"datadir={data_dir}", f"minfile={steps[0]}",
                  f"maxfile={steps[-1]}", "minlevel=0", "maxlevel=1",
                  "components=" + " ".join(chip_smoke.COMPONENTS), *keys,
                  f"compresseddir={comp}", "device=cuda", "-c"]
        d_args = [f"compresseddir={comp}", f"out={out}", *d_keys,
                  "device=cuda", "-d"]
        for what, args in (("compress", c_args), ("decompress", d_args)):
            with chip_smoke._env(env):
                _report(report, f"{name}_{what}", _cli(args))
    for name, depth, keys, _path in chip_smoke.PREVIEWS:
        comp = os.path.join(WORK, f"{name}_arch") + os.sep
        out = os.path.join(WORK, f"{name}_preview{depth}") + os.sep
        _report(report, f"h_{name}_preview{depth}", _cli(
            [f"compresseddir={comp}", f"out={out}", f"preview={depth}",
             *keys, "device=cuda", "-d"]))
    mesh = chip_smoke._two_entry_mesh()
    _api(report, "i_a", data_dir, steps, mesh, {"keep": chip_smoke.KEEP})
    giant_dir = os.path.join(WORK, "giant_data")
    chip_smoke.make_giant_dataset(giant_dir, chip_smoke.GIANT_N)
    giant = {"giant_box_bytes": chip_smoke.GIANT_BYTES}
    _api(report, "j_scales1", giant_dir, [chip_smoke.GIANT_STEP], mesh,
         {"keep": chip_smoke.KEEP, "codec": "raw", **giant}, giant,
         ["density"], 0)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
    with open(opts.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {opts.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
