"""The port's measurement programs against the JAX package's, on the CPU.

``wavelet_tpu_torch.bench`` times the very functions the pipelines call;
each of its stages (forward, mask and inverse on the halves and packed
routes, the large-box forward, the compaction, the scatter) is held
bitwise to its JAX counterpart on the same seeded inputs, and its quality
numbers to what the JAX bench computes with JAX's ``CodecEngine``.  The
speed-of-light guard runs on a fake clock.  The datasets of
``scripts/bench_e2e.py`` and ``scripts/measure_baseline.py`` are the JAX
scripts' byte for byte; the e2e bundle and config 4's archives are
``wavelet_tpu``'s; the scaling bench's meshes of one and two CPU entries
give the same step outputs.  The e2e bench's ``global64`` writes each
mode's dataset seed for seed as the JAX script does, and each mode's bundle
is ``wavelet_tpu``'s.  Without a card and without ``--device cpu`` every
program exits non-zero.
"""

import dataclasses
import importlib.util
import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from conftest import drain_procs, tree_bytes  # noqa: E402

from wavelet_tpu import cli as jcli  # noqa: E402
from wavelet_tpu.core import haar as jhaar  # noqa: E402
from wavelet_tpu.kernels import compact_pallas  # noqa: E402
from wavelet_tpu.pipeline import Config as JConfig  # noqa: E402
from wavelet_tpu.pipeline import compress_run as j_compress  # noqa: E402
from wavelet_tpu.runtime import engine as jengine  # noqa: E402
from wavelet_tpu_torch import bench  # noqa: E402
from wavelet_tpu_torch.kernels import packed_cuda  # noqa: E402
from wavelet_tpu_torch.scripts import bench_e2e  # noqa: E402
from wavelet_tpu_torch.scripts import measure_baseline  # noqa: E402
from wavelet_tpu_torch.scripts import scaling_bench  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DIM = 4, 16
CPU = torch.device("cpu")
SMALL = ["--device", "cpu", "--n", str(N), "--dim", str(DIM), "--reps", "2",
         "--iters", "2", "--large-n", "2", "--large-dim", "16"]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _jax_script(name: str):
    """``scripts/<name>.py`` of the JAX package, loaded with its
    compilation cache off."""
    os.environ["WAVELET_TPU_CACHE"] = "0"
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small():
    """The bench's stage callables at [N, DIM^3] on the CPU, and the
    thresholds of a seeded batch."""
    x = np.random.default_rng(3).standard_normal(
        (N, DIM, DIM, DIM)).astype(np.float32)
    t32 = bench.thresholds(torch.from_numpy(x))
    fns, geo = bench.stages(CPU, N, DIM, t32, 2, 16)
    return x, t32, fns, geo


def _packed(x: np.ndarray, p: int) -> np.ndarray:
    n, d = x.shape[0], x.shape[-1]
    return np.ascontiguousarray(x.reshape(n // p, p, d, d, d)
                                .transpose(0, 2, 3, 1, 4)
                                .reshape(n // p, d, d, p * d))


@pytest.mark.parametrize("route", ["halves", "packed"])
def test_forward_and_inverse_stages_match_jax(small, route):
    x, _, fns, geo = small
    p = geo["pack"]
    assert p == math.gcd(N, packed_cuda.lane_pack_factor((DIM,) * 3)) == 4
    suffix = "" if route == "halves" else "_packed"
    want_c = np.array(jhaar.haar3d_forward(jnp.asarray(x)))
    want_x = np.array(jhaar.haar3d_inverse(jnp.asarray(want_c)))
    if route == "halves":
        c = fns["forward"][0](torch.from_numpy(x))[0]
        back = fns["inverse"][0](torch.from_numpy(want_c))
    else:
        c = packed_cuda.unpack(fns["forward_packed"][0](
            torch.from_numpy(_packed(x, p)))[0], p)
        back = packed_cuda.unpack(fns["inverse_packed"][0](
            torch.from_numpy(_packed(want_c, p))), p)
        assert fns["forward" + suffix][1] == (N // p, DIM, DIM, p * DIM)
    np.testing.assert_array_equal(_bits(c), _bits(want_c))
    np.testing.assert_array_equal(_bits(back), _bits(want_x))


def test_mask_stage_matches_jnp_mask(small):
    x, t32, fns, _ = small
    c = np.array(jhaar.haar3d_forward(jnp.asarray(x)))
    c[0, 0, 0, :4] = [0.0, -0.0, np.nan, -np.inf]
    u, t = jnp.asarray(c), jnp.asarray(t32.numpy())
    want = jnp.where(jnp.abs(u) > t[:, None, None, None], u,
                     jnp.zeros_like(u))
    got = fns["mask"][0](torch.from_numpy(c))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    kept = float((np.asarray(want) != 0).mean())
    assert 0 < kept < 1


def test_large_box_stages_match_jax(small):
    _, _, fns, geo = small
    x = np.random.default_rng(4).standard_normal(geo["large"]).astype(
        np.float32)
    want = _bits(jhaar.haar3d_forward(jnp.asarray(x)))
    for name in ("large_fused", "large_plain"):
        got = fns[name][0](torch.from_numpy(x))
        got = got[0] if isinstance(got, tuple) else got
        np.testing.assert_array_equal(_bits(got), want, name)


def test_compact_stage_matches_compact_pallas_reference(small):
    """Counts, then the first ``count`` (index, value) pairs of every row a
    consumer reads, against the jnp path of ``compact_fast`` and the
    argsort ``engine._compact_step``."""
    _, _, fns, geo = small
    m, cap = DIM ** 3, geo["cap"]
    rows = np.random.default_rng(5).standard_normal((N, m)).astype(
        np.float32)
    rows[1, :400] = 9.0                     # a row past the cap
    counts, idx, vals = (t.numpy() for t in fns["compact"][0](
        torch.from_numpy(rows)))
    t = jnp.full((N,), bench.COMPACT_THRESHOLD, jnp.float32)
    fast = compact_pallas.compact_fast(jnp.asarray(rows), t, cap,
                                       dims=(DIM,) * 3, impl="jnp",
                                       assemble="jnp")
    ref = jengine._compact_step(jnp.asarray(rows), t, cap)
    assert (counts > cap).any() and (counts[counts <= cap] > 0).all()
    for (wc, wi, wv, *over) in ([np.asarray(a) for a in fast],
                                [np.asarray(a) for a in ref]):
        np.testing.assert_array_equal(counts, wc)
        for i, c in enumerate(wc):
            if c > cap or (over and over[0][i]):
                continue
            np.testing.assert_array_equal(idx[i, :c], wi[i, :c])
            np.testing.assert_array_equal(_bits(vals[i, :c]),
                                          _bits(wv[i, :c]))


def test_scatter_stage_matches_engine_scatter_rows(small):
    _, _, fns, geo = small
    fn, shape, _ = fns["scatter"]
    assert shape == ("pairs", N, DIM ** 3, geo["scatter_cap"])
    idx, vals = bench.Inputs(CPU, 9).pairs(*shape[1:])()
    assert idx.dtype == torch.int32     # as the engine hands them over
    got = fn((idx, vals))
    want = jengine._scatter_rows(jnp.asarray(idx.numpy()),
                                 jnp.asarray(vals.numpy()), DIM ** 3)
    np.testing.assert_array_equal(_bits(got.reshape(N, -1)), _bits(want))


@pytest.mark.parametrize("clock", ["run_rep", "perf_counter"])
def test_guard_drops_reps_faster_than_the_card(monkeypatch, clock):
    """A rep faster than bytes x 2 / 3.35e12 is dropped; with every rep
    dropped the floor comes back with ``all_reps_implausible``."""
    nbytes = 1 << 30
    floor = nbytes * 2 / bench.HBM_BYTES_PER_S

    def run(durations):
        if clock == "run_rep":
            it = iter(durations)
            return bench.median_rep(lambda x: next(it), lambda: None,
                                    len(durations), nbytes, 2.0)
        # the CPU timer on a fake clock: each rep reads it before and
        # after its 4 launches
        ticks = iter([v for i, dt in enumerate(durations)
                      for v in (float(i), i + 4 * dt)])
        monkeypatch.setattr(bench.time, "perf_counter", lambda: next(ticks))
        return bench.time_stage(lambda x: None, lambda: None, CPU,
                                len(durations), 4, nbytes)

    dt, sp = run([0.5 * floor, 2 * floor, 3 * floor])
    assert sp["reps_used"] == 2 and sp["reps_dropped_implausible"] == 1
    assert np.isclose(dt, 2.5 * floor)
    assert np.isclose(sp["min_gbps_dt"], 2 * floor)
    assert np.isclose(sp["max_gbps_dt"], 3 * floor)
    assert "all_reps_implausible" not in sp
    dt, sp = run([0.1 * floor, 0.9 * floor])
    assert dt == floor and sp["all_reps_implausible"] is True
    assert sp["reps_used"] == 0 and sp["reps_dropped_implausible"] == 2
    assert sp["min_gbps_dt"] == sp["max_gbps_dt"] == floor


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240, **kw)


@pytest.fixture(scope="module")
def bench_line(tmp_path_factory):
    out = _run(["wavelet_tpu_torch.bench", *SMALL])
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 1, out.stdout
    return json.loads(lines[-1])


EXTRA_KEYS = ("forward", "mask", "inverse", "decompress_gbps",
              "roundtrip_gbps", "pipeline_device_stage_gbps",
              "headline_layout", "decompress_layout", "large_box_128",
              "sparse_compact_stage", "sparse_scatter_stage", "keep",
              "kept_coeff_fraction", "roundtrip_rmse", "platform",
              "block_shape", "bytes", "methodology", "name", "power.limit",
              "e2e")


def test_bench_prints_one_json_line_with_every_key(bench_line):
    r = bench_line
    assert r["metric"] == "device_compress_throughput_per_chip"
    assert r["unit"] == "GB/s" and r["value"] > 0
    # both are rounded to 3 places from the same unrounded rate
    assert math.isclose(r["vs_baseline"], r["value"] / 10.0, abs_tol=6e-4)
    ex = r["extra"]
    assert set(EXTRA_KEYS) <= set(ex), set(EXTRA_KEYS) - set(ex)
    assert ex["platform"] == "cpu" and ex["name"] is None
    assert ex["block_shape"] == [N, DIM, DIM, DIM]
    assert ex["bytes"] == N * DIM ** 3 * 4 and ex["e2e"] is None
    assert ex["headline_layout"] in ("halves", "packed")
    for k in ("forward", "forward_packed", "mask", "inverse",
              "inverse_packed"):
        assert ex[k]["reps_used"] == 2 and "all_reps_implausible" not in ex[k]
    assert ex["sparse_compact_stage"]["reps_used"] == 2
    assert ex["sparse_scatter_stage"]["reps_used"] == 2
    assert ex["large_box_128"]["block_shape"] == [2, 16, 16, 16]
    # CPU tensors take the plain versions: no kernel counts
    assert not any(ex["launches"].values())


def test_bench_quality_matches_the_jax_engine(bench_line):
    """``kept_coeff_fraction`` and ``roundtrip_rmse`` as ``bench.py``
    computes them with JAX's ``CodecEngine`` on the same seed."""
    orig = np.random.default_rng(0).standard_normal(
        (N, DIM, DIM, DIM)).astype(np.float32)
    eng = jengine.CodecEngine()
    flat, mask = eng.compress_batch(orig, 0.999)
    recon = eng.decompress_batch(np.where(mask, flat, 0.0), (DIM,) * 3)
    rmse = float(np.sqrt(np.mean(
        (recon.astype(np.float64) - orig.astype(np.float64)) ** 2)))
    ex = bench_line["extra"]
    assert ex["kept_coeff_fraction"] == round(float(mask.mean()), 6)
    assert ex["roundtrip_rmse"] == rmse


def test_e2e_summary_is_the_given_artifact(tmp_path):
    """``extra.e2e`` summarises only an artifact named by ``--e2e``; a
    named artifact that is absent is an error, not a null."""
    art = {"semantics": "s", "card": {"name": "x"},
           "cube64": {"collected": {"e2e_measured_gbps": 1.5,
                                    "link_share_of_wall": 0.1,
                                    "e2e_link_normalized_gbps": {"point": 2},
                                    "reconciliation": {"agreement": 1.0}}}}
    path = tmp_path / "e2e.json"
    path.write_text(json.dumps(art))
    s = bench._e2e_summary(str(path))
    assert s["e2e_measured_gbps"] == 1.5 and s["card"] == {"name": "x"}
    assert bench._e2e_summary(None) is None
    with pytest.raises(FileNotFoundError):
        bench._e2e_summary(str(tmp_path / "absent.json"))


@pytest.mark.parametrize("module,args", [
    ("wavelet_tpu_torch.bench", ["--n", "4", "--dim", "16"]),
    ("wavelet_tpu_torch.scripts.bench_e2e", ["--boxes", "2"]),
    ("wavelet_tpu_torch.scripts.scaling_bench", ["--devices", "2"]),
    ("wavelet_tpu_torch.scripts.scaling_bench", ["--devices", "2",
                                                 "--repeat"]),
    ("wavelet_tpu_torch.scripts.measure_baseline", ["--only", "6"]),
    ("wavelet_tpu_torch.scripts.bench_e2e", ["--configs", "global64",
                                             "--boxes", "2"]),
])
def test_programs_without_a_card_exit_non_zero(tmp_path, module, args):
    """The default device is the card: without one each program raises,
    prints no result and writes no artifact."""
    assert not torch.cuda.is_available()
    out_file = tmp_path / "out.json"
    extra = [] if module.endswith(".bench") else ["--out", str(out_file)]
    p = _run([module, *args, *extra])
    assert p.returncode != 0
    assert "Error" in p.stderr.splitlines()[-1], p.stderr[-2000:]
    assert "{" not in p.stdout and not out_file.exists()


def test_e2e_datasets_are_the_jax_script_s(tmp_path):
    jscript = _jax_script("bench_e2e")
    for seed in (1, 12):
        a = bench_e2e.smooth_spiky_boxes(3, 16, seed)
        b = jscript.smooth_spiky_boxes(3, 16, seed)
        np.testing.assert_array_equal(_bits(a), _bits(b))
        bench_e2e.write_dataset(str(tmp_path / "t"), f"plt{seed:05d}", a, 16)
        jscript.write_dataset(str(tmp_path / "j"), f"plt{seed:05d}", b, 16)
    want = tree_bytes(tmp_path / "j")
    assert len(want) == 6 and tree_bytes(tmp_path / "t") == want


@pytest.fixture(scope="module")
def e2e_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    res = bench_e2e.main(["--device", "cpu", "--root", str(root), "--out",
                          str(root / "e2e.json"), "--configs", "cube64",
                          "--boxes", "3", "--timesteps", "2",
                          "--keep-files"])
    run_dir = type(root)(res["run_dir"])
    assert run_dir.parent == root
    return run_dir, res


def test_e2e_bundle_is_the_jax_cli_s(e2e_run, tmp_path):
    """The streaming variant's archive (``codec=raw archive=bundle
    keep=0.999 prefetch=1``) byte for byte ``python -m wavelet_tpu.cli``'s
    on the same dataset and keys."""
    root, _ = e2e_run
    jdir = str(tmp_path / "jax") + os.sep
    assert jcli.main([f"datadir={root}/cube64/data_s", "minfile=plt00600",
                      "maxfile=plt00601", "minlevel=0", "maxlevel=0",
                      "components=f", "keep=0.999", "codec=raw",
                      "archive=bundle", "prefetch=1", f"compresseddir={jdir}",
                      "-c"]) == 0
    want = tree_bytes(jdir)
    assert len(want) > 3
    assert tree_bytes(root / "cube64" / "arch_s") == want


def test_e2e_rows_carry_the_jax_script_s_fields(e2e_run):
    root, res = e2e_run
    with open(root.parent / "e2e.json") as f:
        assert json.load(f)["cube64"] == json.loads(json.dumps(
            res["cube64"], default=float))
    row = res["cube64"]
    assert row["input_bytes"] == 2 * 3 * 64 ** 3 * 4
    for variant in ("collected", "streaming"):
        v = row[variant]
        for k in ("e2e_measured_gbps", "link_share_of_wall",
                  "e2e_link_normalized_gbps", "reconciliation"):
            assert k in v, (variant, k)
        assert v["e2e_measured_gbps"] > 0 and v["files"] == 6
        assert v["link_share_of_wall"] is None      # no link on the CPU
        rec = v["reconciliation"]
        assert rec["predicted_wall_s"] > 0 and rec["agreement"] > 0
    assert row["decompress_streaming"]["e2e_measured_gbps"] > 0
    assert set(row["stage_rates_gbps"]) == {"device_forward", "host_pack",
                                            "read"}


def test_e2e_run_removes_only_what_it_made(tmp_path):
    """Each run writes into a directory of its own under ``--root`` and
    removes it; what was under ``--root`` before, even a directory named
    after a configuration, stays as it was."""
    (tmp_path / "cube64").mkdir()
    (tmp_path / "cube64" / "mine.txt").write_text("x")
    res = bench_e2e.main(["--device", "cpu", "--root", str(tmp_path),
                          "--out", str(tmp_path / "e2e.json"), "--configs",
                          "cube64", "--boxes", "1", "--timesteps", "1"])
    assert os.path.dirname(res["run_dir"]) == str(tmp_path)
    assert not os.path.exists(res["run_dir"])
    assert sorted(os.listdir(tmp_path)) == ["cube64", "e2e.json"]
    assert (tmp_path / "cube64" / "mine.txt").read_text() == "x"


@pytest.fixture(scope="module")
def global_run(tmp_path_factory):
    """``--configs global64 --boxes 2 --timesteps 2 --keep-files`` on the
    CPU: (the configuration's directory, its row)."""
    root = tmp_path_factory.mktemp("g64")
    res = bench_e2e.main(["--device", "cpu", "--root", str(root), "--out",
                          str(root / "e2e.json"), "--configs", "global64",
                          "--boxes", "2", "--timesteps", "2",
                          "--keep-files"])
    with open(root / "e2e.json") as f:
        assert json.load(f)["global64"] == json.loads(json.dumps(
            res["global64"], default=float))
    return type(root)(res["run_dir"]) / "global64", res["global64"]


GLOBAL_MODES = [m for m, _ in bench_e2e.GLOBAL_MODES]


def test_global64_datasets_are_the_jax_script_s(global_run, tmp_path):
    """Mode ``mi``'s timestep ``t`` holds ``smooth_spiky_boxes(2, 64,
    seed=100 * mi + 10 * t + 3)``, written as the JAX script writes it."""
    root, _ = global_run
    jscript = _jax_script("bench_e2e")
    assert GLOBAL_MODES == ["box", "global_cached", "global_uncached"]
    for mi, mode in enumerate(GLOBAL_MODES):
        jdir = str(tmp_path / mode)
        for t in range(2):
            jscript.write_dataset(jdir, f"plt{600 + t:05d}",
                                  jscript.smooth_spiky_boxes(
                                      2, 64, seed=100 * mi + 10 * t + 3), 64)
        want = tree_bytes(jdir)
        assert len(want) == 6
        assert tree_bytes(root / f"data_{mode}") == want, mode


@pytest.mark.parametrize("mode", GLOBAL_MODES)
def test_global64_bundles_are_wavelet_tpu_s(global_run, tmp_path,
                                            monkeypatch, mode):
    """Each mode's bundle byte for byte ``wavelet_tpu``'s ``compress_run``
    of the JAX script's ``Config`` on the same dataset, with the default
    cache budget; its cached timesteps and threshold are JAX's too."""
    root, row = global_run
    monkeypatch.delenv("WAVELET_TPU_GLOBALCACHE", raising=False)
    extra = dict(bench_e2e.GLOBAL_MODES)[mode]
    jdir = str(tmp_path / "jax") + os.sep
    jstats = j_compress(JConfig(
        data_dir=str(root / f"data_{mode}"), min_time="plt00600",
        max_time="plt00601", min_level=0, max_level=0, components=["f"],
        keep=0.999, compressed_dir=jdir, codec="raw", archive="bundle",
        prefetch=1, **extra))
    want = tree_bytes(jdir)
    assert sum(k.endswith(".wtb") for k in want) == 2
    assert tree_bytes(root / f"arch_{mode}") == want
    assert row[mode]["cached_timesteps"] == jstats.get(
        "global_cached_timesteps")
    assert row[mode]["global_threshold"] == jstats.get("global_threshold")


def test_global64_row_carries_the_jax_script_s_fields(global_run):
    """The JAX row's fields, the stage seconds and bytes the cube rows
    carry, and the cache at work: box mode caches nothing (null, as in
    the JAX row), the cached mode both timesteps, the uncached none."""
    _, row = global_run
    assert {k: row[k] for k in ("dim", "boxes_per_timestep", "timesteps",
                                "input_bytes", "codec", "archive")} == {
        "dim": 64, "boxes_per_timestep": 2, "timesteps": 2,
        "input_bytes": 2 * 2 * 64 ** 3 * 4, "codec": "raw",
        "archive": "bundle"}
    for mode in GLOBAL_MODES:
        assert set(row[mode]) == {
            "wall_seconds", "e2e_measured_gbps", "cached_timesteps",
            *bench_e2e.STAGE_KEYS, "global_threshold"}, mode
        assert row[mode]["wall_seconds"] > 0
        assert row[mode]["e2e_measured_gbps"] > 0
        assert row[mode]["device_to_host_bytes"] == row["input_bytes"]
    assert [row[m]["cached_timesteps"] for m in GLOBAL_MODES] == [None, 2, 0]
    assert row["box"]["global_threshold"] is None
    assert all(row[m]["global_threshold"] > 0 for m in GLOBAL_MODES[1:])
    walls = [row[m]["wall_seconds"] for m in GLOBAL_MODES]
    assert row["cached_vs_box_wall_ratio"] == round(walls[1] / walls[0], 3)
    assert row["cached_vs_uncached_speedup"] == round(walls[2] / walls[1], 3)


def test_global64_removes_each_mode_s_dataset(tmp_path, monkeypatch):
    """Without ``--keep-files`` each mode's dataset is gone before the next
    mode runs, the run's directory at the end, and what was under
    ``--root`` before stays as it was."""
    (tmp_path / "global64").mkdir()
    (tmp_path / "global64" / "mine.txt").write_text("x")
    seen = []
    run = bench_e2e.compress_mod.compress_run

    def spy(cfg):
        seen.append(sorted(os.listdir(os.path.dirname(cfg.data_dir))))
        return run(cfg)

    monkeypatch.setattr(bench_e2e.compress_mod, "compress_run", spy)
    res = bench_e2e.main(["--device", "cpu", "--root", str(tmp_path),
                          "--out", str(tmp_path / "e2e.json"), "--configs",
                          "global64", "--boxes", "1", "--timesteps", "1"])
    assert seen == [["data_box"],
                    ["arch_box", "data_global_cached"],
                    ["arch_box", "arch_global_cached",
                     "data_global_uncached"]]
    assert not os.path.exists(res["run_dir"])
    assert sorted(os.listdir(tmp_path)) == ["e2e.json", "global64"]
    assert (tmp_path / "global64" / "mine.txt").read_text() == "x"


@pytest.mark.parametrize("keep_files", [False, True])
def test_global64_checks_free_space_first(tmp_path, monkeypatch, keep_files):
    """Too little room for one mode's f64 dataset and the bundles (for all
    three datasets under ``--keep-files``) is an error before anything is
    written."""
    dim, n, t = bench_e2e.CONFIGS["global64"]
    input_bytes = t * n * dim ** 3 * 4
    datasets = 3 if keep_files else 1
    free = input_bytes * 2 * datasets        # no room for the bundles
    monkeypatch.setattr(bench_e2e.shutil, "disk_usage",
                        lambda p: type("U", (), {"free": free})())
    with pytest.raises(OSError, match="the global64 run needs"):
        bench_e2e.run_global_config("global64", dim, n, t, str(tmp_path),
                                    CPU, keep_files)
    assert os.listdir(tmp_path / "global64") == []


def test_baseline_datasets_are_the_jax_script_s(tmp_path):
    jscript = _jax_script("measure_baseline")
    for mod, side in ((measure_baseline, "t"), (jscript, "j")):
        d = str(tmp_path / side)
        mod.synthetic_plotfile(d, n_boxes=8, dim=8, offset=3.0 + 1e-3 * 2)
        mod.synthetic_plotfile(d, n_boxes=1, dim=16, ncomp=1, name="plt1")
        mod.spiky_plotfile(d, n_boxes=3, dim=16, name="plt00061", seed=8)
    want = tree_bytes(tmp_path / "j")
    assert len(want) == 9 and tree_bytes(tmp_path / "t") == want
    # the mode lists are the JAX script's
    assert measure_baseline.CONFIG4_MODES == (
        ("box", {"keep": 0.999}),
        ("box_sparse", {"keep": 0.999, "transfer": "sparse"}),
        ("global", {"keep_fraction": 0.02}))
    assert [m for m, _ in measure_baseline.CONFIG5_MODES] == [
        "parity_xz_files", "raw_files", "raw_bundle", "raw_sparse_bundle"]


def test_baseline_config4_archives_are_jax_s(tmp_path):
    """Config 4 at 64 boxes (``--scale 0.064``): each mode's archive byte
    for byte ``wavelet_tpu``'s ``compress_run`` of the JAX script's
    ``Config`` on the same dataset."""
    results = {}
    work = str(tmp_path / "t")
    measure_baseline.config4(results, work, 0.064, "cpu")
    rows = results["config4_large_synthetic"]
    data = os.path.join(work, "synth")
    for mode, extra in measure_baseline.CONFIG4_MODES:
        assert rows[mode]["boxes"] == 64 and rows[mode]["files"] == 128
        assert rows[mode]["compress_gbps_e2e"] > 0
        jdir = str(tmp_path / f"j_{mode}") + os.sep
        jcfg = JConfig(data_dir=data, min_time="plt00030",
                       max_time="plt00030", min_level=0, max_level=0,
                       components=["smooth", "noisy"], compressed_dir=jdir,
                       threshold_mode=mode.split("_")[0], **extra)
        j_compress(jcfg)
        port = measure_baseline.config4_config(data, work, mode, extra, "cpu")
        shared = [f.name for f in dataclasses.fields(JConfig)
                  if f.name != "compressed_dir"]
        assert ({k: getattr(port, k) for k in shared}
                == {k: getattr(jcfg, k) for k in shared})
        want = tree_bytes(jdir)
        assert len(want) > 10
        assert tree_bytes(port.compressed_dir) == want, mode


def test_baseline_config6_at_scale_through_main(tmp_path):
    res = measure_baseline.main(["--device", "cpu", "--only", "6",
                                 "--scale", "0.0625", "--out",
                                 str(tmp_path / "m.json")])
    rows = res["config6_e2e_sparse_regime"]
    for transfer in ("dense", "sparse"):
        r = rows[transfer]
        assert r["boxes"] == 4
        for k in ("compress_gbps_e2e", "decompress_gbps_e2e",
                  "host_to_device_bytes", "decompress_seconds"):
            assert r[k] > 0, (transfer, k)
    assert (rows["sparse"]["host_to_device_bytes"]
            < rows["dense"]["host_to_device_bytes"])
    assert json.loads((tmp_path / "m.json").read_text())["scale"] == 0.0625
    with pytest.raises(ValueError, match="golden plotfiles"):
        measure_baseline.main(["--device", "cpu", "--only", "1,3"])


def test_scaling_bench_on_two_cpu_entries(tmp_path):
    res = scaling_bench.main(["--device", "cpu", "--devices", "2", "--dim",
                              "8", "--per-device-boxes", "2", "--iters", "2",
                              "--out", str(tmp_path / "s.json")])
    assert sorted(res["meshes"]) == ["1", "2"]
    assert res["distinct_devices"] == 1 and "NOT scaling" in res["note"]
    for size, row in res["meshes"].items():
        assert row["mesh_size"] == int(size)
        assert row["outputs_equal_to_mesh1"] is True
        for step in ("parity", "global"):
            assert row[step]["gbps_total"] > 0
            assert len(row[step]["gbps_reps"]) == 3
    assert res["meshes"]["1"]["parity"]["scaling_efficiency"] == 1.0
    assert json.loads((tmp_path / "s.json").read_text()) == res
    assert scaling_bench.mesh_entries("cpu", 3, False) == ["cpu"] * 3


def test_scaling_bench_over_two_processes(tmp_path):
    """``--coordinator``: each mesh is the global mesh of both processes'
    entries (2, then 4), every mesh gives the smallest one's outputs, and
    each process exits cleanly with its group torn down at exit."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    out = tmp_path / "s.json"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "wavelet_tpu_torch.scripts.scaling_bench",
         "--device", "cpu", "--devices", "2", "--dim", "4",
         "--per-device-boxes", "1", "--iters", "1", "--out", str(out),
         "--coordinator", f"127.0.0.1:{port}", "--processes", "2",
         "--processid", str(i)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for i in range(2)]
    outs = drain_procs(procs, timeout=240)
    for p, o in zip(procs, outs):
        assert p.returncode == 0 and "terminate called" not in o, o[-3000:]
    res = json.loads(out.read_text())
    assert sorted(res["meshes"]) == ["2", "4"] and res["processes"] == 2
    assert all(r["outputs_equal_to_mesh1"] for r in res["meshes"].values())
    assert res["gloo_bytes"]["all_reduce"] > 0
