"""``-estimate``, ``-check`` and ``-info`` in the port, against the JAX
package, on the CPU.

Synthetic plotfiles (one timestep, one level, two components, boxes of
mixed shapes, some of which the halves route lane-packs) go through
``wavelet_tpu.pipeline.estimate.estimate_run`` and the port's
``estimate_run`` with ``device=cpu``, at the default layout and under
``WAVELET_TPU_LAYOUT=halves``: the reported RMSE, adjusted loss, size
percentage and global threshold must be equal (host metrics are exact:
the same masked coefficients, the same double-accumulation estimator).
``devicemetrics=1`` sums float32 in another order than XLA, so it is held
to the JAX package's ``_rmse_step`` to ``rtol=1e-5``.  ``-check`` and
``-info`` must return JAX's dicts on a sound archive and on one with a
truncated member, and the CLI must give JAX's exit codes and messages.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from conftest import tree_bytes  # noqa: E402

from wavelet_tpu import cli as jcli  # noqa: E402
from wavelet_tpu.pipeline import Config as JConfig  # noqa: E402
from wavelet_tpu.pipeline import check as jcheck  # noqa: E402
from wavelet_tpu.pipeline.estimate import estimate_run as j_estimate  # noqa: E402
from wavelet_tpu.runtime import engine as jengine  # noqa: E402
import wavelet_tpu_torch  # noqa: E402
from wavelet_tpu_torch import cli  # noqa: E402
from wavelet_tpu_torch.io import plotfile  # noqa: E402
from wavelet_tpu_torch.pipeline import common  # noqa: E402
from wavelet_tpu_torch.pipeline.estimate import estimate_run  # noqa: E402
from wavelet_tpu_torch.runtime import engine  # noqa: E402

COMPS = ["density", "temp"]
GLOBAL = {"threshold_mode": "global", "keep_fraction": 0.05}
CASES = {
    "box": {},
    "global": GLOBAL,
    "fast": {"fast_estimate": True},
    "fast_global": {**GLOBAL, "fast_estimate": True},
    "keep_sweep": {"keep_sweep": [0.99, 0.999, 0.9999]},
    "fast_keep_sweep": {"keep_sweep": [0.99, 0.999], "fast_estimate": True},
    "keepfraction_sweep": {"threshold_mode": "global",
                           "keep_fraction": 0.01,
                           "keep_fraction_sweep": [0.01, 0.05]},
    "q16": {"payload": "q16"},
    "bundle": {"archive": "bundle"},
    "fast_bundle": {"archive": "bundle", "fast_estimate": True},
    "scales2": {"scales": 2},
}
SHAPES = [((0, 0, 0), (16, 16, 16)), ((16, 0, 0), (8, 4, 2)),
          ((24, 0, 0), (7, 5, 3)), ((0, 16, 0), (5, 3, 16)),
          ((8, 16, 0), (16, 8, 8))]


def _write_data(root: str) -> str:
    rng = np.random.default_rng(21)
    data = os.path.join(root, "data")
    boxes = []
    for _, d in SHAPES:
        x, y, z = np.meshgrid(*[np.arange(n) for n in d], indexing="ij")
        f = (np.tanh((x + 0.5 * y - 0.3 * z - 4.0) / 1.5)
             + 0.01 * rng.standard_normal(d))
        boxes.append(np.stack([((1.0 + q) * f).astype(np.float32)
                               for q in range(2)]))
    plotfile.write_plotfile(
        os.path.join(data, "plt00010"), [boxes], [[loc for loc, _ in SHAPES]],
        [[d for _, d in SHAPES]], COMPS, 0.5, [0.0, 0.0, 0.0],
        [1.0, 0.5, 0.5], (2, 2, 2), (32, 32, 16), [10])
    return data


def _cfg(cls, data, **kw):
    return cls(data_dir=data, min_time="plt00010", max_time="plt00010",
               min_level=0, max_level=0, components=list(COMPS), keep=0.999,
               **kw)


def _with_layout(monkeypatch, layout):
    if layout == "default":
        monkeypatch.delenv("WAVELET_TPU_LAYOUT", raising=False)
    else:
        monkeypatch.setenv("WAVELET_TPU_LAYOUT", layout)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _write_data(str(tmp_path_factory.mktemp("torch_estimate")))


@pytest.fixture(scope="module")
def jax_results(data):
    return {name: j_estimate(_cfg(JConfig, data, **kw))
            for name, kw in CASES.items()}


@pytest.mark.parametrize("layout", ["default", "halves"])
@pytest.mark.parametrize("case", list(CASES))
def test_estimate_equals_jax(data, jax_results, case, layout, monkeypatch):
    _with_layout(monkeypatch, layout)
    got = estimate_run(_cfg(common.Config, data, device="cpu",
                            **CASES[case]))
    assert got == jax_results[case]


def test_estimate_api_and_cli_report_the_same(data, jax_results, caplog):
    got = wavelet_tpu_torch.estimate(data, min_time="plt00010",
                                     components=COMPS, device="cpu")
    assert got == jax_results["box"]
    caplog.set_level("INFO", logger="wavelet_tpu_torch")
    assert cli.main([f"datadir={data}", "minfile=plt00010", "minlevel=0",
                     "components=density temp", "keep=0.99 0.999 0.9999",
                     "device=cpu", "-estimate"]) == 0
    assert "Predicted compressed size" in caplog.text


@pytest.mark.parametrize("layout", ["default", "halves"])
@pytest.mark.parametrize("case", ["box", "fast", "global"])
def test_devicemetrics_within_rtol_of_jax(data, case, layout, monkeypatch):
    _with_layout(monkeypatch, layout)
    kw = {**CASES[case], "device_metrics": True}
    want = j_estimate(_cfg(JConfig, data, **kw))
    got = estimate_run(_cfg(common.Config, data, device="cpu", **kw))
    assert got.keys() == want.keys()
    assert got["compressed_size_pct"] == want["compressed_size_pct"]
    for name in COMPS:
        for metric in ("rmse", "adjusted_loss"):
            np.testing.assert_allclose(got["components"][name][metric],
                                       want["components"][name][metric],
                                       rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 16, 16, 16), (3, 7, 5, 3),
                                   (2, 64, 32, 5)])
def test_rmse_batch_matches_jax_rmse_step(shape):
    """The chunked two-stage f32 sum, with and without padding chunks."""
    rng = np.random.default_rng(22)
    a = rng.standard_normal(shape).astype(np.float32)
    b = (a + 1e-3 * rng.standard_normal(shape)).astype(np.float32)
    got = engine.CodecEngine(device="cpu").rmse_batch(a, b)
    want = np.asarray(jengine._rmse_step(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (shape[0],) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_estimate_refusals_match_jax(data):
    for kw in ({"threshold_mode": "global", "keep_fraction": 0.1,
                "keep_sweep": [0.9, 0.99]},
               {"keep_fraction_sweep": [0.1]},
               {"threshold_mode": "global"}):
        with pytest.raises(ValueError) as want:
            j_estimate(_cfg(JConfig, data, **kw))
        with pytest.raises(ValueError) as got:
            estimate_run(_cfg(common.Config, data, device="cpu", **kw))
        assert str(got.value) == str(want.value)


# ---- -check and -info ------------------------------------------------------

@pytest.fixture(scope="module")
def archives(data, tmp_path_factory):
    """(files archive, bundle archive) compressed by the port."""
    root = tmp_path_factory.mktemp("torch_check")
    out = []
    for fmt in ("files", "bundle"):
        arch = str(root / fmt) + os.sep
        wavelet_tpu_torch.compress(data, arch, min_time="plt00010",
                                   max_time="plt00010", components=COMPS,
                                   archive=fmt, device="cpu")
        out.append(arch)
    return out


def _truncated_copy(src, dst):
    import shutil

    shutil.copytree(src, dst)
    victim = sorted(n for n in os.listdir(dst)
                    if n.endswith(".xz") or n.endswith(".wtb"))[0]
    path = os.path.join(dst, victim)
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    return dst


@pytest.mark.parametrize("damaged", [False, True])
@pytest.mark.parametrize("fmt", [0, 1])
def test_check_and_info_equal_jax(archives, tmp_path, fmt, damaged):
    arch = archives[fmt]
    if damaged:
        arch = _truncated_copy(arch, str(tmp_path / "damaged"))
    cfg = common.Config(compressed_dir=arch)
    jcfg = JConfig(compressed_dir=arch)
    got, want = wavelet_tpu_torch.check(arch), jcheck.check_run(jcfg)
    assert got == want
    assert bool(got["errors"]) == damaged
    if not damaged or fmt == 0:
        # a truncated bundle has no readable index: -info raises in both
        assert wavelet_tpu_torch.info(arch) == jcheck.info_run(jcfg)
    else:
        with pytest.raises(Exception) as jerr:
            jcheck.info_run(jcfg)
        with pytest.raises(type(jerr.value)):
            wavelet_tpu_torch.info(arch)
    assert cli.main([f"compresseddir={arch}", "-check"]) == (1 if damaged
                                                              else 0)
    from wavelet_tpu_torch.pipeline import check

    assert check.check_run(cfg) == got


def test_cli_info_and_check_exit_codes(archives, tmp_path):
    assert cli.main([f"compresseddir={archives[0]}", "-info"]) == 0
    assert cli.main([f"compresseddir={tmp_path / 'none'}", "-info"]) == 1
    assert cli.main([f"compresseddir={tmp_path / 'none'}", "-check"]) == 1


# ---- the CLI grammar -------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [],
    ["-check"],
    ["datadir=x", "minfile=a", "maxfile=b", "minlevel=0", "maxlevel=0",
     "components=temp", "keep=0.9 0.99", "compresseddir=y", "-c"],
    ["datadir=x", "minfile=a", "maxfile=b", "minlevel=0", "maxlevel=0",
     "components=temp", "thresholdmode=global", "keepfraction=0.1 0.2",
     "compresseddir=y", "-c"],
    ["datadir=x", "minfile=a", "minlevel=0", "components=temp",
     "-estimate"],
    ["datadir=x", "minfile=a", "minlevel=0", "components=temp",
     "thresholdmode=global", "keepfraction=0.1", "keep=0.9 0.99",
     "-estimate"],
])
def test_cli_messages_like_jax(argv):
    with pytest.raises(SystemExit) as want:
        jcli.parse_argv(argv)
    with pytest.raises(SystemExit) as got:
        cli.parse_argv(argv + ["device=cpu"])
    assert str(got.value) == str(want.value)


def test_cli_estimate_keys_like_jax():
    argv = ["datadir=x", "minfile=a", "minlevel=1", "components=temp rho",
            "keep=0.99 0.999", "fastestimate=1", "devicemetrics=1",
            "scales=2", "-estimate"]
    mode, cfg = cli.parse_argv(argv + ["device=cpu"])
    jmode, jcfg = jcli.parse_argv(argv)
    assert mode == jmode == "estimate"
    for k in ("data_dir", "min_time", "max_time", "min_level", "max_level",
              "components", "keep", "keep_sweep", "fast_estimate",
              "device_metrics", "scales", "compressed_dir",
              "keep_fraction_sweep"):
        assert getattr(cfg, k) == getattr(jcfg, k), k
    argv = ["datadir=x", "minfile=a", "maxfile=b", "minlevel=0",
            "maxlevel=2", "components=temp", "thresholdmode=global",
            "keepfraction=0.1 0.2", "-estimate"]
    cfg, jcfg = cli.parse_argv(argv)[1], jcli.parse_argv(argv)[1]
    assert cfg.keep_fraction_sweep == jcfg.keep_fraction_sweep == [0.1, 0.2]
    assert (cfg.max_time, cfg.max_level) == (jcfg.max_time,
                                             jcfg.max_level) == ("b", 2)
    for m in ("check", "info"):
        assert cli.parse_argv(["compresseddir=z", f"-{m}"])[0] == m


@pytest.mark.parametrize("layout", ["default", "halves"])
@pytest.mark.parametrize("kw", [{}, {"transfer": "sparse"},
                                {"threshold_mode": "global",
                                 "keep_fraction": 0.05}],
                         ids=["box", "sparse", "global"])
def test_compress_collected_writes_compress_runs_archive(data, tmp_path, kw,
                                                         layout, monkeypatch):
    """compress_collected + write_sidecars make the streaming pipeline's
    archive, and a resumed rerun writes nothing."""
    from wavelet_tpu_torch.io import archive
    from wavelet_tpu_torch.pipeline import compress

    _with_layout(monkeypatch, layout)
    want = str(tmp_path / "want")
    wavelet_tpu_torch.compress(data, want, min_time="plt00010",
                               max_time="plt00010", components=COMPS,
                               device="cpu", **kw)
    got = str(tmp_path / "got")
    os.makedirs(got)
    files = common.format_files(data, "plt00010", "plt00010")
    run = common.collect_run(files, COMPS, [0])
    compress.write_sidecars(run, 0, 0, got)
    mode = kw.get("threshold_mode", "box")
    archive.write_meta(got, threshold_mode=mode, keep=0.999,
                       keep_fraction=kw.get("keep_fraction"))
    stats = compress.compress_collected(
        run, 0.999, got, threshold_mode=mode,
        keep_fraction=kw.get("keep_fraction"),
        transfer=kw.get("transfer", "dense"), device="cpu")
    assert tree_bytes(got) == tree_bytes(want)
    assert stats["files"] == 2 * len(SHAPES)
    again = compress.compress_collected(
        run, 0.999, got, threshold_mode=mode,
        keep_fraction=kw.get("keep_fraction"), resume=True, device="cpu")
    assert again["skipped"] == 2 * len(SHAPES) and again["files"] == 0
    assert tree_bytes(got) == tree_bytes(want)
