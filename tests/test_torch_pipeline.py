"""End-to-end parity of the port's pipelines with the JAX package.

Synthetic plotfiles (boxes of mixed even and odd shapes, 2 timesteps,
2 levels, 2 components) are compressed by ``wavelet_tpu`` (its CPU halves
path) and by ``wavelet_tpu_torch`` with ``device=cpu``.  The archives must
be byte-identical for the default settings, for ``archive=bundle``,
``payload=q16`` and ``codec=raw``, for 2- and 3-scale pyramids (the
shapes mix pyramid depths 1, 2 and 3), and for global thresholds (one and
two scales, no coefficient cache, bundles), and each package must
regenerate byte-identical plotfiles from the other's archive.  The archive
format is the state the two packages share; no converter exists or is
needed.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from conftest import tree_bytes  # noqa: E402

from wavelet_tpu import cli as jcli  # noqa: E402
from wavelet_tpu.io import plotfile  # noqa: E402
from wavelet_tpu.pipeline import Config as JConfig  # noqa: E402
from wavelet_tpu.pipeline import compress_run as j_compress  # noqa: E402
from wavelet_tpu.pipeline import decompress_run as j_decompress  # noqa: E402
import wavelet_tpu_torch  # noqa: E402
from wavelet_tpu_torch import cli  # noqa: E402
from wavelet_tpu_torch.pipeline import decompress as t_decompress  # noqa: E402
from wavelet_tpu_torch.runtime import engine  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPS = ["density", "temp"]
GLOBAL = {"threshold_mode": "global", "keep_fraction": 0.02}
VARIANTS = {
    "default": {},
    "bundle": {"archive": "bundle"},
    "q16": {"payload": "q16"},
    "raw": {"codec": "raw"},
    "scales2": {"scales": 2},
    "scales3": {"scales": 3},
    "global": GLOBAL,
    "global_scales2": {**GLOBAL, "scales": 2},
    "global_nocache": {**GLOBAL, "scales": 2, "global_cache_bytes": 0},
    "global_bundle": {**GLOBAL, "archive": "bundle"},
}


def _field(shape, t, q, rng):
    x, y, z = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    f = (np.tanh((x + 0.5 * y - 0.3 * z - 5.0 + 2.0 * t) / 1.5)
         + 0.2 * np.sin(0.4 * y + q) + 0.01 * rng.standard_normal(shape))
    return ((1.0 + q) * f).astype(np.float32)


def _write_data(root: str) -> str:
    rng = np.random.default_rng(11)
    data = os.path.join(root, "data")
    l0 = [((0, 0, 0), (8, 8, 8)), ((8, 0, 0), (8, 8, 8))]
    l1 = [((0, 0, 0), (7, 5, 3)), ((8, 0, 0), (8, 4, 2)),
          ((16, 0, 0), (16, 8, 8)), ((0, 8, 0), (9, 6, 5))]
    for t, name in enumerate(["plt00010", "plt00020"]):
        boxes = [[np.stack([_field(d, t, q, rng) for q in range(2)])
                  for _, d in lev] for lev in (l0, l1)]
        plotfile.write_plotfile(
            os.path.join(data, name), boxes,
            [[loc for loc, _ in lev] for lev in (l0, l1)],
            [[d for _, d in lev] for lev in (l0, l1)],
            COMPS, 0.5 + t, [0.0, 0.0, 0.0], [1.0, 0.5, 0.5], (2, 2, 2),
            (16, 8, 8), [10 * (t + 1), 20 * (t + 1)])
    return data


def _cargs(data, comp, **kw):
    return dict(data_dir=data, min_time="plt00010", max_time="plt00020",
                min_level=0, max_level=1, components=list(COMPS),
                keep=0.999, compressed_dir=comp, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' archives and regenerated plotfiles per variant."""
    root = str(tmp_path_factory.mktemp("torch_pipeline"))
    data = _write_data(root)
    out = {"data": data, "root": root, "stats": {}}
    for name, kw in VARIANTS.items():
        d = os.path.join(root, name)
        j_arch, t_arch = d + "/jax_arch/", d + "/torch_arch/"
        j_stats = j_compress(JConfig(**_cargs(data, j_arch, **kw)))
        t_stats = wavelet_tpu_torch.compress(
            data, t_arch, min_time="plt00010", max_time="plt00020",
            components=COMPS, min_level=0, max_level=1, keep=0.999,
            device="cpu", **kw)
        j_decompress(JConfig(compressed_dir=j_arch, out_dir=d + "/jax_out/"))
        out[name] = (j_arch, t_arch, d + "/jax_out/")
        out["stats"][name] = (j_stats, t_stats)
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_archives_byte_identical(runs, variant):
    j_arch, t_arch, _ = runs[variant]
    want = tree_bytes(j_arch)
    assert len(want) > 5
    assert tree_bytes(t_arch) == want


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cross_decompress_byte_identical(runs, variant):
    j_arch, t_arch, j_out = runs[variant]
    root = os.path.join(runs["root"], variant)
    want = tree_bytes(j_out)
    assert len(want) == 10     # 2 timesteps x (Header + 2 x (Cell_H, Cell_D))
    # the port reads the JAX package's archive ...
    wavelet_tpu_torch.decompress(j_arch, root + "/t_of_j/", device="cpu")
    assert tree_bytes(root + "/t_of_j/") == want
    # ... and the JAX package reads the port's
    j_decompress(JConfig(compressed_dir=t_arch, out_dir=root + "/j_of_t/"))
    assert tree_bytes(root + "/j_of_t/") == want


class _TwoWorkers(engine.HostPacker):
    def __init__(self, *a, **k):
        k["workers"] = 2
        super().__init__(*a, **k)


@pytest.mark.parametrize("variant", ["default", "bundle", "q16", "scales2"])
def test_streamed_decompress_matches_jax(runs, variant, tmp_path,
                                         monkeypatch):
    """The port's streamed decode (two workers with no chunk floor: each timestep's 8^3 bucket of four members decodes
    largest first in two chunks of two rows, each chunk's device stage
    and assemble on its own) regenerates the JAX package's plotfiles of
    the JAX package's archive byte for byte."""
    j_arch, _, j_out = runs[variant]
    monkeypatch.setattr(engine, "HostPacker", _TwoWorkers)
    monkeypatch.setattr(t_decompress, "_STREAM_MIN_CHUNK_BYTES", 0)
    stats = wavelet_tpu_torch.decompress(j_arch, str(tmp_path / "t"),
                                         device="cpu")
    assert stats["unpack_wait_seconds"] > 0       # the bucket streamed
    assert tree_bytes(tmp_path / "t") == tree_bytes(j_out)


def test_partial_retrieval_matches_jax(runs, tmp_path):
    j_arch = runs["default"][0]
    sel = dict(min_time="plt00020", max_time="plt00020",
               components=["temp"], levels_upto=0)
    j_decompress(JConfig(compressed_dir=j_arch, out_dir=str(tmp_path / "j"),
                         **sel))
    wavelet_tpu_torch.decompress(j_arch, str(tmp_path / "t"), device="cpu",
                                 **sel)
    want = tree_bytes(tmp_path / "j")
    assert set(want) == {"plt00020/Header", "plt00020/Level_0/Cell_H",
                         "plt00020/Level_0/Cell_D_00000"}
    assert tree_bytes(tmp_path / "t") == want


def test_cli_module_run_and_resume(runs, tmp_path):
    """``python -m wavelet_tpu_torch.cli`` end to end; a resumed rerun
    rewrites nothing and the archive stays the JAX package's."""
    arch = str(tmp_path / "arch") + os.sep
    base = [sys.executable, "-m", "wavelet_tpu_torch.cli",
            f"datadir={runs['data']}", "minfile=plt00010",
            "maxfile=plt00020", "minlevel=0", "maxlevel=1",
            "components=density temp", "keep=0.999",
            f"compresseddir={arch}", "device=cpu", "-c"]
    env = dict(os.environ, PYTHONPATH=REPO)
    for extra in ([], ["resume=1"]):
        p = subprocess.run(base + extra, cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stdout + p.stderr
    assert tree_bytes(arch) == tree_bytes(runs["default"][0])
    out = str(tmp_path / "out") + os.sep
    assert cli.main([f"compresseddir={arch}", f"out={out}", "device=cpu",
                     "-d"]) == 0
    assert tree_bytes(out) == tree_bytes(runs["default"][2])


def test_cli_device_cuda_raises_without_cuda(runs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = str(tmp_path / "arch") + os.sep
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([f"datadir={runs['data']}", "minfile=plt00010",
                  "maxfile=plt00020", "minlevel=0", "maxlevel=1",
                  "components=temp", "keep=0.999", f"compresseddir={arch}",
                  "-c"])      # device=cuda is the default
    assert not os.path.exists(arch)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([f"compresseddir={runs['default'][0]}",
                  f"out={tmp_path / 'out'}", "device=cuda", "-d"])


def test_cli_unported_modes_raise():
    """The port runs every key value of the JAX CLI: no refusal list is
    left, and an unknown ``giantmesh=`` value is refused as the JAX CLI
    refuses it."""
    assert not hasattr(cli, "_UNPORTED")
    argv = ["datadir=x", "minfile=a", "maxfile=b", "minlevel=0",
            "maxlevel=0", "components=temp", "keep=0.9", "compresseddir=y",
            "giantmesh=bogus", "devices=2", "-c"]
    with pytest.raises(SystemExit) as got:
        cli.parse_argv(argv + ["device=cpu"])
    with pytest.raises(SystemExit) as want:
        jcli.parse_argv(argv)
    assert str(got.value) == str(want.value) == (
        "Unknown giantmesh='bogus' (local|global)")


@pytest.mark.parametrize("option", [{"giant_mesh": "global"},
                                    {"process_id": 1},
                                    {"coordinator": "localhost:1"}])
def test_api_rejects_unported_options(runs, tmp_path, option):
    # the process group is joined before the call
    # (runtime/mesh.init_distributed), not through the API; giant_mesh is
    # a Config field, and in one process a global giant mesh is this
    # process's mesh, so the archive is the default run's
    kw = dict(min_time="plt00010", max_time="plt00020",
              components=list(COMPS), min_level=0, max_level=1, keep=0.999,
              device="cpu")
    if "giant_mesh" in option:
        wavelet_tpu_torch.compress(runs["data"], str(tmp_path / "a"),
                                   **kw, **option)
        assert tree_bytes(tmp_path / "a") == tree_bytes(runs["default"][0])
        return
    with pytest.raises(TypeError, match="unknown option"):
        wavelet_tpu_torch.compress(runs["data"], str(tmp_path / "a"), **kw,
                                   **option)
    assert not os.path.exists(tmp_path / "a")


def test_scales_and_global_change_the_archive(runs):
    """The variants' keys reach the codec: each archive differs from the
    default's in its payloads, not only in the meta file."""
    def payloads(name):
        tree = tree_bytes(runs[name][0])
        return {k: v for k, v in tree.items() if k.endswith(".xz")}

    default = payloads("default")
    for name in ("scales2", "scales3", "global", "global_scales2"):
        assert payloads(name) != default, name
    assert payloads("scales2") != payloads("scales3")
    assert payloads("global_nocache") == payloads("global_scales2")


@pytest.mark.parametrize("variant", [v for v in VARIANTS if "global" in v])
def test_global_threshold_and_cache_stats_match_jax(runs, variant):
    j_stats, t_stats = runs["stats"][variant]
    assert t_stats["global_threshold"] == j_stats["global_threshold"] > 0
    assert (t_stats["global_cached_timesteps"]
            == j_stats["global_cached_timesteps"]
            == (0 if variant == "global_nocache" else 2))
    assert t_stats["files"] == j_stats["files"] == 2 * 6 * 2
    assert t_stats["input_bytes"] == j_stats["input_bytes"]
    for k in ("read_seconds", "device_seconds", "pack_wait_seconds"):
        assert t_stats[k] > 0


@pytest.mark.parametrize("variant", ["global_scales2", "global_bundle"])
def test_global_resume_gives_the_fresh_archive(runs, tmp_path, variant):
    """A resumed global run derives the threshold from every item, so after
    losing some payloads (files) or a timestep's bundle it rewrites them
    with the fresh run's bytes; the bundle case appends a new generation,
    which decodes to the same plotfiles."""
    kw = VARIANTS[variant]
    arch = str(tmp_path / "arch") + os.sep
    args = dict(min_time="plt00010", max_time="plt00020", components=COMPS,
                min_level=0, max_level=1, keep=0.999, device="cpu", **kw)
    wavelet_tpu_torch.compress(runs["data"], arch, **args)
    if kw.get("archive") == "bundle":
        names = sorted(n for n in os.listdir(arch) if n.endswith(".wtb"))
        assert len(names) == 2
        os.remove(os.path.join(arch, names[1]))
    else:
        names = sorted(n for n in os.listdir(arch) if n.endswith(".xz"))
        for n in names[::3]:
            os.remove(os.path.join(arch, n))
    stats = wavelet_tpu_torch.compress(runs["data"], arch, resume=True,
                                       **args)
    assert stats["skipped"] > 0 and stats["files"] > 0
    assert stats["global_threshold"] == \
        runs["stats"][variant][0]["global_threshold"]
    want_out = tree_bytes(runs[variant][2])
    if kw.get("archive") != "bundle":
        assert tree_bytes(arch) == tree_bytes(runs[variant][0])
    wavelet_tpu_torch.decompress(arch, str(tmp_path / "out"), device="cpu")
    assert tree_bytes(tmp_path / "out") == want_out


def test_cli_global_and_scales_run_like_jax(runs, tmp_path):
    """``-c`` with the new keys through the port's CLI: the archive is the
    JAX package's, and ``-d`` regenerates its plotfiles."""
    arch = str(tmp_path / "arch") + os.sep
    assert cli.main([f"datadir={runs['data']}", "minfile=plt00010",
                     "maxfile=plt00020", "minlevel=0", "maxlevel=1",
                     "components=density temp", "thresholdmode=global",
                     "keepfraction=0.02", "scales=2", "globalcache=0",
                     f"compresseddir={arch}", "device=cpu", "-c"]) == 0
    assert tree_bytes(arch) == tree_bytes(runs["global_nocache"][0])
    out = str(tmp_path / "out") + os.sep
    assert cli.main([f"compresseddir={arch}", f"out={out}", "device=cpu",
                     "-d"]) == 0
    assert tree_bytes(out) == tree_bytes(runs["global_nocache"][2])


_BASE = ["datadir=x", "minfile=a", "maxfile=b", "minlevel=0", "maxlevel=0",
         "components=temp", "compresseddir=y", "device=cpu", "-c"]


@pytest.mark.parametrize("extra", [
    ["thresholdmode=global", "keep=0.9"],                  # no keepfraction
    ["thresholdmode=global", "keepfraction=0.1", "keep=0.9 0.99"],
    ["thresholdmode=global", "keepfraction=0.1 0.2"],
    ["keep=0.9 0.99"],
    ["keep=0.9", "globalcache=-1"],
])
def test_cli_errors_match_jax(extra):
    from wavelet_tpu import cli as jcli

    with pytest.raises(SystemExit) as want:
        jcli.parse_argv(_BASE + extra)
    with pytest.raises(SystemExit) as got:
        cli.parse_argv(_BASE + extra)
    assert str(got.value) == str(want.value) and str(got.value)


def test_cli_parses_global_keys_like_jax():
    from wavelet_tpu import cli as jcli

    argv = _BASE + ["thresholdmode=global", "keepfraction=0.05", "scales=3",
                    "globalcache=1024"]
    _, cfg = cli.parse_argv(argv)
    _, jcfg = jcli.parse_argv(argv)
    for k in ("threshold_mode", "keep_fraction", "keep", "scales",
              "global_cache_bytes"):
        assert getattr(cfg, k) == getattr(jcfg, k), k


def test_api_global_without_keep_fraction_raises(runs, tmp_path):
    with pytest.raises(ValueError, match="keep_fraction"):
        wavelet_tpu_torch.compress(
            runs["data"], str(tmp_path / "a"), min_time="plt00010",
            max_time="plt00010", components=["temp"], device="cpu",
            threshold_mode="global")
    assert not os.path.exists(tmp_path / "a")
