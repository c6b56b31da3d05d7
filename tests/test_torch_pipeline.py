"""End-to-end parity of the port's pipelines with the JAX package.

Synthetic plotfiles (boxes of mixed even and odd shapes, 2 timesteps,
2 levels, 2 components) are compressed by ``wavelet_tpu`` (its CPU halves
path) and by ``wavelet_tpu_torch`` with ``device=cpu``.  The archives must
be byte-identical for the default settings and for ``archive=bundle``,
``payload=q16`` and ``codec=raw``, and each package must regenerate
byte-identical plotfiles from the other's archive.  The archive format is
the state the two packages share; no converter exists or is needed.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from conftest import tree_bytes  # noqa: E402

from wavelet_tpu.io import plotfile  # noqa: E402
from wavelet_tpu.pipeline import Config as JConfig  # noqa: E402
from wavelet_tpu.pipeline import compress_run as j_compress  # noqa: E402
from wavelet_tpu.pipeline import decompress_run as j_decompress  # noqa: E402
import wavelet_tpu_torch  # noqa: E402
from wavelet_tpu_torch import cli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPS = ["density", "temp"]
VARIANTS = {
    "default": {},
    "bundle": {"archive": "bundle"},
    "q16": {"payload": "q16"},
    "raw": {"codec": "raw"},
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
    out = {"data": data, "root": root}
    for name, kw in VARIANTS.items():
        d = os.path.join(root, name)
        j_arch, t_arch = d + "/jax_arch/", d + "/torch_arch/"
        j_compress(JConfig(**_cargs(data, j_arch, **kw)))
        wavelet_tpu_torch.compress(
            data, t_arch, min_time="plt00010", max_time="plt00020",
            components=COMPS, min_level=0, max_level=1, keep=0.999,
            device="cpu", **kw)
        j_decompress(JConfig(compressed_dir=j_arch, out_dir=d + "/jax_out/"))
        out[name] = (j_arch, t_arch, d + "/jax_out/")
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


@pytest.mark.parametrize("argv", [
    ["thresholdmode=global", "keepfraction=0.1", "-c"],
    ["scales=2", "-c"],
    ["transfer=sparse", "-c"],
    ["devices=2", "-c"],
    ["-estimate"],
    ["-check"],
])
def test_cli_unported_modes_raise(argv):
    with pytest.raises(NotImplementedError):
        cli.parse_argv(["datadir=x", "minfile=a", "maxfile=b", "minlevel=0",
                        "maxlevel=0", "components=temp", "keep=0.9",
                        "compresseddir=y", "device=cpu"] + argv)


@pytest.mark.parametrize("option", [{"scales": 2}, {"giant_box_bytes": 1},
                                    {"transfer": "sparse"}])
def test_api_rejects_unported_options(runs, tmp_path, option):
    with pytest.raises(TypeError, match="unknown option"):
        wavelet_tpu_torch.compress(
            runs["data"], str(tmp_path / "a"), min_time="plt00010",
            max_time="plt00010", components=["temp"], device="cpu",
            **option)
    assert not os.path.exists(tmp_path / "a")
