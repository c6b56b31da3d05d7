"""The benchmark's four-rank global-threshold cell at a CPU test's size.

- ``wtbench/reference/global_threshold.py`` against the port: its
  two-scale pyramid and its histogram equal the port's plain forward bit
  for bit, and its bin rule equals ``threshold_from_histogram``, also on
  the step-down and empty cases;
- the driver ``wtbench/drivers/compress_global.py``: four ``device=cpu``
  ranks on localhost gloo, at 8 boxes of 16^3 and two fields, give check
  numbers of all 0, and their threshold and archive equal a one-process
  run's byte for byte, as their histograms sum to the whole run's;
- the bfloat16 control fails;
- a rank killed mid-window ends the driver with an error well inside its
  deadline, and no rank is left running;
- the readers of the cell's per-layer metrics.

Each multi-process run is a subprocess under one deadline, so a group left
behind cannot reach the other tests of this process.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from wavelet_tpu_torch.core import haar, threshold  # noqa: E402
from wavelet_tpu_torch.kernels import pyramid_cuda  # noqa: E402
from wtbench import datagen, drivers, metrics, spec  # noqa: E402
from wtbench.drivers import Run  # noqa: E402
from wtbench.reference import check  # noqa: E402
from wtbench.reference import global_threshold as ref  # noqa: E402

ROOT = spec.ROOT
CELL = "nyx_node4.compress_global"
SEED = 2 ** 31 + 977
DEADLINE_S = 240

# the tiny dataset, built in the test process and in each subprocess alike
TINY = r'''
from wtbench import datagen, spec

FIELDS = 2
_generate = datagen.generate


def tiny_generate(config, cfg, seed, device):
    ds = _generate(config, cfg, seed, device)
    for s in ds.snapshots:
        s.boxes = [[b[:FIELDS].copy() for b in lev] for lev in s.boxes]
    ds.components = ds.components[:FIELDS]
    return ds


datagen.generate = tiny_generate


class TinyBench(spec.Bench):
    def config(self, name):
        cfg = super().config(name)
        cfg.update(cells=32, max_grid_size=16)
        return cfg
'''

# set-up, a short window and the check of the driver as the harness runs
# them, then a one-process run of the same call over the same plotfiles
SHARE = TINY + r'''
import json, os, shutil, sys, tempfile
import numpy as np
import torch
from wavelet_tpu_torch.kernels import pyramid_cuda
from wavelet_tpu_torch.runtime import mesh
from wtbench import drivers, run
from wtbench.datagen import plotfile
from wtbench.drivers.compress_global_rank import compress_share
from wtbench.reference import archive, global_threshold

def tree(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}

bench = TinyBench()
cell = bench.cell("nyx_node4.compress_global")
traffic = bench.traffic(cell["traffic"])
ds = datagen.generate(cell["config"], bench.config(cell["config"]), int(sys.argv[1]), "cpu")
work = tempfile.mkdtemp(prefix="wtbench-global4-")
ctx = run.Context(dataset=ds, traffic=traffic, seed=1, device="cpu", work=work,
                  data_dir=os.path.join(work, "data"))
plotfile.write_dataset(ctx.data_dir, ds)
drv = drivers.load(traffic["kind"]).Driver(ctx)
drv.setup()
records = drv.window(0.5)
numbers, failed = drv.check(records)
alive = [p.poll() is None for p in drv.procs]
one = os.path.join(work, "one")
stats = compress_share(drv.plan, one, "cpu")   # the same call, one process
items = [ds.item(k) for k in ds.items()]
x = torch.from_numpy(np.stack(items))
shares = [items[slice(r * len(items) // 4, (r + 1) * len(items) // 4)] for r in range(4)]
summed = sum(pyramid_cuda.forward_hist(torch.from_numpy(np.stack(s)), traffic["scales"])[1]
             for s in shares)
whole = pyramid_cuda.forward_hist(x, traffic["scales"])[1]
refh = global_threshold.histogram(global_threshold.pyramid(x, traffic["scales"]))
print(json.dumps({
    "numbers": numbers, "failed": failed, "passes": len(records),
    "alive": alive, "process_count": mesh.process_count(),
    "thresholds": [st["global_threshold"] for r in records for st in r["rank_stats"]],
    "one_threshold": stats["global_threshold"],
    "same_archive": [tree(r["dir"]) == tree(one) for r in records],
    "members": len(archive.members(one)),
    "allreduce": [st.get("allreduce_seconds") for st in records[0]["rank_stats"]],
    "summed_stats": sorted(records[0]["stats"]),
    "hist_equal": [bool((summed == whole).all()), bool((refh == whole).all())],
    "hist_total": int(whole.sum()),
}))
shutil.rmtree(work)
'''

# a rank killed in the window: the driver must raise, and soon
KILL = TINY + r'''
import json, os, shutil, sys, tempfile, threading, time
from wtbench import drivers, run
from wtbench.datagen import plotfile

bench = TinyBench()
cell = bench.cell("nyx_node4.compress_global")
traffic = bench.traffic(cell["traffic"])
ds = datagen.generate(cell["config"], bench.config(cell["config"]), 7, "cpu")
work = tempfile.mkdtemp(prefix="wtbench-global4-kill-")
ctx = run.Context(dataset=ds, traffic=traffic, seed=7, device="cpu", work=work,
                  data_dir=os.path.join(work, "data"))
plotfile.write_dataset(ctx.data_dir, ds)
drv = drivers.load(traffic["kind"]).Driver(ctx)
drv.setup()
victim = drv.procs[1]
threading.Timer(1.0, victim.kill).start()
t0 = time.time()
try:
    drv.window(60.0)
    err = None
except RuntimeError as e:
    err = str(e)
print(json.dumps({"error": err, "seconds": time.time() - t0,
                  "alive": [p.poll() is None for p in drv.procs]}))
shutil.rmtree(work)
'''


def _subprocess(code: str, *args) -> dict:
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=DEADLINE_S)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# -- the reference against the port ------------------------------------------

SHAPES = [(16, 16, 16), (8, 12, 16), (4, 8, 4), (32, 16, 8)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_reference_pyramid_equals_the_port(shape):
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn((5, *shape), generator=g).cumsum(-1) * 100.0
    x[0] = 0.0                       # a flat box: all in bin 0
    x[1, 0, 0, 0] = float("inf")     # the inf bin
    want, hist = pyramid_cuda.forward_hist_plain(x, 2)
    got = ref.pyramid(x, 2)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(haar.haar3d_forward_multi(x, 2).view(torch.int32),
                       got.view(torch.int32))
    assert torch.equal(ref.histogram(got), hist)
    assert torch.equal(ref.histogram(got),
                       threshold.abs_exponent_histogram(want))


def _hist(kind: str) -> np.ndarray:
    rng = np.random.default_rng(len(kind))
    h = np.zeros(threshold.EXP_HIST_BINS, np.int64)
    if kind == "lognormal":
        mags = rng.lognormal(0, 3, 1 << 16).astype(np.float32)
        np.add.at(h, mags.view(np.int32) >> 20, 1)
    elif kind == "sparse":
        h[rng.choice(2048, 30, replace=False)] = rng.integers(1, 1000, 30)
    elif kind == "one_bin":            # the target inside the top bin
        h[1000] = 12345
    elif kind == "two_bins":
        h[900], h[1000] = 10, 1
    elif kind == "low_bins":          # only bins 0 and 1: threshold 0
        h[0], h[1] = 50, 7
    elif kind == "bin_two":
        h[0], h[2] = 50, 7
    elif kind == "top_bin":
        h[2047] = 3
    return h                           # "empty": all zero


KINDS = ["lognormal", "sparse", "one_bin", "two_bins", "low_bins", "bin_two",
         "top_bin", "empty"]


@pytest.mark.parametrize("frac", [0.0, 0.02, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("kind", KINDS)
def test_reference_bin_rule_equals_the_port(kind, frac):
    h = _hist(kind)
    want = threshold.threshold_from_histogram(h, frac)
    got = ref.bin_threshold(h, frac)
    assert np.float32(got).view(np.uint32) == np.float32(want).view(np.uint32)


def test_reference_bin_rule_at_the_exact_target():
    """A target equal to a count keeps the bins that hold it: the smallest
    bin k whose bins k and up hold no more, the empty bins below the
    populated one included."""
    h = np.zeros(2048, np.int64)
    h[[500, 600, 700]] = [50, 30, 20]     # total 100
    t = ref.bin_threshold(h, 0.5)         # bins >= 600 hold exactly 50
    assert np.float32(t).view(np.uint32) == (501 << 20) - 1
    t = ref.bin_threshold(h, 0.49)        # then only bin 700's 20 fit
    assert np.float32(t).view(np.uint32) == (601 << 20) - 1


# -- the driver ---------------------------------------------------------------

def _tiny_dataset(seed: int):
    ns = {}
    exec(TINY, ns)
    try:
        bench = ns["TinyBench"]()
        cell = bench.cell(CELL)
        ds = datagen.generate(cell["config"], bench.config(cell["config"]),
                              seed, "cpu")
    finally:
        datagen.generate = ns["_generate"]
    return bench, cell, ds


def test_four_ranks_equal_one_process():
    r = _subprocess(SHARE, SEED)
    assert r["numbers"] == {"missing_members": 0, "wrong_members": 0,
                            "threshold_mismatch": 0}
    assert r["failed"] == 0 and r["passes"] >= 1
    assert check.verdict(r["numbers"], drivers.load("compress_global").LIMITS)
    assert r["alive"] == [False, False, False]
    assert r["process_count"] == 1          # the group is gone
    assert r["thresholds"] == [r["one_threshold"]] * (4 * r["passes"])
    assert all(r["same_archive"]) and r["members"] == 8 * 2
    assert all(v is not None and v >= 0 for v in r["allreduce"])
    for key in ("global_pass1_seconds", "global_pass2_seconds",
                "allreduce_seconds", "global_cached_timesteps",
                "global_reread_timesteps", "compress_seconds"):
        assert key in r["summed_stats"]
    assert "global_threshold" not in r["summed_stats"]
    assert r["hist_equal"] == [True, True]
    assert r["hist_total"] == 8 * 2 * 16 ** 3


def test_the_bfloat16_control_fails():
    bench, cell, ds = _tiny_dataset(SEED)
    traffic = bench.traffic(cell["traffic"])
    mod = drivers.load(traffic["kind"])
    numbers = mod.control(ds, traffic, SEED, "cpu", torch.bfloat16)
    assert not check.verdict(numbers, mod.LIMITS)
    assert numbers["wrong_members"] > 0
    same = mod.control(ds, traffic, SEED, "cpu", torch.float32)
    assert same == {"missing_members": 0, "wrong_members": 0,
                    "threshold_mismatch": 0}


def test_a_killed_rank_ends_the_driver_with_an_error():
    r = _subprocess(KILL)
    assert r["error"] is not None and "rank 2 exited" in r["error"], r
    assert r["seconds"] < 30, r
    assert r["alive"] == [False, False, False]


# -- the readers -------------------------------------------------------------

GB = 1e9
RANKS = [{"global_pass1_seconds": 1.0, "global_pass2_seconds": 2.0,
          "allreduce_seconds": 0.5, "compress_seconds": 4.0,
          "input_bytes": 100},
         {"global_pass1_seconds": 1.5, "global_pass2_seconds": 2.5,
          "allreduce_seconds": 0.0, "compress_seconds": 6.0,
          "input_bytes": 100}]


def _run(rank_stats, with_keys=True):
    from wtbench.drivers.compress_global import _sum_stats

    rec = {"wall": 10.0, "f32_bytes": 0.5 * GB, "items": 8,
           "stats": _sum_stats(rank_stats), "rank_stats": rank_stats,
           "scales": 2, "rank0_f32_bytes": 0.125 * GB,
           "rank0_hist_calls": 2}
    if not with_keys:
        rec = {k: rec[k] for k in ("wall", "f32_bytes", "items", "stats")}
    return Run(produces="archive", records=[rec, dict(rec)])


@pytest.mark.parametrize("name,value", [
    ("hist_pass_s_per_gb.global4", 2 * 2.5 / 1.0),
    ("pack_pass_s_per_gb.global4", 2 * 4.5 / 1.0),
    ("allreduce_wait_s_per_gb.global4", 2 * 0.5 / 1.0),
    ("rank_skew.global4", 100.0 * 6.0 / 5.0),
    ("compress_gbps.global4", 1.0 / 20.0),
])
def test_global4_reader_value(name, value):
    assert metrics.load(name)(_run(RANKS)) == pytest.approx(value)


@pytest.mark.parametrize("name", [
    "hist_pass_s_per_gb.global4", "pack_pass_s_per_gb.global4",
    "allreduce_wait_s_per_gb.global4", "rank_skew.global4",
    "hist_kernel_roofline.global4", "device_idle_share.global4",
    "compress_gbps.global4"])
def test_global4_reader_absent(name):
    """A program without the spans (the parent's stats), a run without a
    trace, a record without the ranks: the metric is left out."""
    old = [{k: v for k, v in st.items() if not k.startswith(("global_",
                                                             "allreduce"))}
           for st in RANKS]
    if name == "rank_skew.global4":
        assert metrics.load(name)(_run(RANKS, with_keys=False)) is None
    elif name != "compress_gbps.global4":      # the harness's own clock
        assert metrics.load(name)(_run(old)) is None
    assert metrics.load(name)(Run(produces="archive")) is None


def test_hist_kernel_roofline_counts_both_scales():
    from wtbench.trace import Trace

    run = _run(RANKS)
    run.trace = Trace(window_s=1.0, has_device=True, busy_s=0.5,
                      by_name={"void pyramid_forward_scale_kernel<1, true>":
                               0.2, "other": 1.0})
    run.peak_bw = 1e12
    nbytes = 2 * (2.25 * 0.125 * GB + 2 * 2048 * 8)
    assert metrics.load("hist_kernel_roofline.global4")(run) == \
        pytest.approx(100.0 * nbytes / 1e12 / 0.2)

