"""The port's preview (``-d preview=p``) against the JAX package.

``haar3d_lowpass`` and ``CodecEngine.preview_shapebatch`` are held
bitwise (int32 views) to ``wavelet_tpu``'s at depths 1-3 over archives of
1-3 scales: the corner slice (depth == scales), the remaining inverse
(depth < scales, K2 at one scale left, K7 deeper) and the full inverse
then low-pass (depth > scales).  Preview plotfiles of files, bundle and q16
archives, and with partial retrieval, must be byte-identical to
``wavelet_tpu``'s ``decompress_run(preview=...)``.  On the CPU the kernel
wrappers run their plain versions; tests/test_torch_cuda.py holds the
kernels to them on the card.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from conftest import tree_bytes  # noqa: E402

from wavelet_tpu import cli as jcli  # noqa: E402
from wavelet_tpu.core import haar as jhaar  # noqa: E402
from wavelet_tpu.io import plotfile  # noqa: E402
from wavelet_tpu.pipeline import Config as JConfig  # noqa: E402
from wavelet_tpu.pipeline import compress_run as j_compress  # noqa: E402
from wavelet_tpu.pipeline import decompress_run as j_decompress  # noqa: E402
from wavelet_tpu.runtime import batching as jbatching  # noqa: E402
from wavelet_tpu.runtime import engine as jengine  # noqa: E402
import wavelet_tpu_torch  # noqa: E402
from wavelet_tpu_torch import cli  # noqa: E402
from wavelet_tpu_torch.core import haar  # noqa: E402
from wavelet_tpu_torch.runtime import batching, engine  # noqa: E402
from wavelet_tpu_torch.runtime.mesh import data_mesh  # noqa: E402

COMPS = ["density", "temp"]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _boxes(n, dims, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n,) + tuple(dims)) * 50).astype(np.float32)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("dims", [(8, 8, 8), (16, 8, 24), (32, 16, 8)])
def test_lowpass_matches_jax_and_pyramid_corner(dims, depth):
    x = _boxes(3, dims, depth)
    got = haar.haar3d_lowpass(torch.from_numpy(x), depth).numpy()
    want = np.asarray(jhaar.haar3d_lowpass(x, depth))
    assert got.shape == (3,) + tuple(d >> depth for d in dims)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # bitwise the LLL corner the forward pyramid stores
    pyr = haar.haar3d_forward_multi(torch.from_numpy(x), depth).numpy()
    cx, cy, cz = (d >> depth for d in dims)
    np.testing.assert_array_equal(_bits(got), _bits(pyr[:, :cx, :cy, :cz]))


def _coeff_batch(mod, dims, scales, n, seed):
    """A logical-order coefficient batch of the forward pyramids of ``n``
    random boxes (plus one padding row), for package ``mod``'s batching."""
    x = _boxes(n + 1, dims, seed)
    x[n] = 0.0
    c = haar.haar3d_forward_multi(torch.from_numpy(x), scales).numpy()
    items = [mod.WorkItem(t=0, level=0, comp_idx=0, box=b) for b in range(n)]
    return mod.ShapeBatch(shape=tuple(dims), data=c.copy(), items=items,
                          n_valid=n, layout="halves", scales=scales)


@pytest.mark.parametrize("scales", [1, 2, 3])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_preview_shapebatch_matches_jax(scales, depth):
    dims = (16, 8, 8)
    got, got_h2d = engine.CodecEngine(device="cpu", scales=scales) \
        .preview_shapebatch(_coeff_batch(batching, dims, scales, 3, 7),
                            depth)
    want, want_h2d = jengine.CodecEngine(scales=scales).preview_shapebatch(
        _coeff_batch(jbatching, dims, scales, 3, 7), depth)
    assert got.shape == (4,) + tuple(d >> depth for d in dims)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert got_h2d == want_h2d
    if depth == scales:
        assert got_h2d == 0          # the corner alone: no device work
    elif depth < scales:
        assert got_h2d == 4 * int(np.prod([d >> depth for d in dims])) * 4


def test_preview_over_a_mesh_equals_one_device():
    batch = _coeff_batch(batching, (16, 8, 8), 2, 7, 9)
    one = engine.CodecEngine(device="cpu", scales=2)
    eight = engine.CodecEngine(device="cpu", scales=2,
                               mesh=data_mesh(["cpu"] * 8))
    for depth in (1, 2, 3):
        a, ha = one.preview_shapebatch(batch, depth)
        b, hb = eight.preview_shapebatch(batch, depth)
        np.testing.assert_array_equal(_bits(a), _bits(b))
        assert ha == hb


def test_preview_rejects_indivisible_dims_like_jax():
    batch = _coeff_batch(batching, (8, 4, 2), 1, 2, 3)
    with pytest.raises(ValueError) as got:
        engine.CodecEngine(device="cpu").preview_shapebatch(batch, 2)
    with pytest.raises(ValueError) as want:
        jengine.CodecEngine().preview_shapebatch(
            _coeff_batch(jbatching, (8, 4, 2), 1, 2, 3), 2)
    assert str(got.value) == str(want.value)


def _field(shape, t, q, rng):
    x, y, z = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    f = (np.tanh((x + 0.5 * y - 0.3 * z - 5.0 + 2.0 * t) / 1.5)
         + 0.2 * np.sin(0.4 * y + q) + 0.01 * rng.standard_normal(shape))
    return ((1.0 + q) * f).astype(np.float32)


def _write_data(root: str) -> str:
    """Two timesteps, two levels, two components; every box location and
    dim divides by 8, so previews up to depth 3 are valid."""
    rng = np.random.default_rng(5)
    data = os.path.join(root, "data")
    l0 = [((0, 0, 0), (16, 8, 8)), ((16, 0, 0), (16, 8, 8))]
    l1 = [((0, 0, 0), (32, 16, 16)), ((32, 0, 0), (8, 8, 8)),
          ((0, 16, 0), (16, 8, 8))]
    for t, name in enumerate(["plt00010", "plt00020"]):
        boxes = [[np.stack([_field(d, t, q, rng) for q in range(2)])
                  for _, d in lev] for lev in (l0, l1)]
        plotfile.write_plotfile(
            os.path.join(data, name), boxes,
            [[loc for loc, _ in lev] for lev in (l0, l1)],
            [[d for _, d in lev] for lev in (l0, l1)],
            COMPS, 0.5 + t, [0.0, 0.0, 0.0], [1.0, 0.5, 0.5], (2, 2, 2),
            (32, 16, 16), [10 * (t + 1), 20 * (t + 1)])
    return data


ARCHIVES = {"files": {}, "bundle": {"archive": "bundle"},
            "q16": {"payload": "q16"}, "scales2": {"scales": 2},
            "scales3": {"scales": 3}}


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """The JAX package's archives of the same data, one per flavour."""
    root = str(tmp_path_factory.mktemp("torch_preview"))
    data = _write_data(root)
    out = {"root": root, "data": data}
    for name, kw in ARCHIVES.items():
        arch = os.path.join(root, name) + os.sep
        j_compress(JConfig(data_dir=data, min_time="plt00010",
                           max_time="plt00020", min_level=0, max_level=1,
                           components=list(COMPS), keep=0.999,
                           compressed_dir=arch, **kw))
        out[name] = arch
    return out


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("flavour", list(ARCHIVES))
def test_preview_plotfiles_match_jax(archives, tmp_path, flavour, depth):
    arch = archives[flavour]
    j_decompress(JConfig(compressed_dir=arch, out_dir=str(tmp_path / "j"),
                         preview=depth))
    stats = wavelet_tpu_torch.decompress(arch, str(tmp_path / "t"),
                                         device="cpu", preview=depth)
    want = tree_bytes(tmp_path / "j")
    assert len(want) == 2 * (1 + 2 * 2)
    assert tree_bytes(tmp_path / "t") == want
    scales = ARCHIVES[flavour].get("scales", 1)
    if depth == scales:
        assert stats["host_to_device_bytes"] == 0


@pytest.mark.parametrize("depth", [1, 2])
def test_preview_with_partial_retrieval_matches_jax(archives, tmp_path,
                                                    depth):
    sel = dict(min_time="plt00020", components=["temp"], levels_upto=0,
               preview=depth)
    j_decompress(JConfig(compressed_dir=archives["scales2"],
                         out_dir=str(tmp_path / "j"), **sel))
    wavelet_tpu_torch.decompress(archives["scales2"], str(tmp_path / "t"),
                                 device="cpu", **sel)
    want = tree_bytes(tmp_path / "j")
    assert set(want) == {"plt00020/Header", "plt00020/Level_0/Cell_H",
                         "plt00020/Level_0/Cell_D_00000"}
    assert tree_bytes(tmp_path / "t") == want


def _lowpass_np(a, depth):
    """Block means in float32, one rounding per combine (the Haar low
    band), along Z, Y, X per round."""
    a = np.asarray(a, np.float32)
    for _ in range(depth):
        a = ((a[..., 0::2] + a[..., 1::2]) * np.float32(0.5)).astype(
            np.float32)
        a = ((a[:, 0::2, :] + a[:, 1::2, :]) * np.float32(0.5)).astype(
            np.float32)
        a = ((a[0::2] + a[1::2]) * np.float32(0.5)).astype(np.float32)
    return a


@pytest.mark.parametrize("depth", [1, 2])
def test_preview_is_the_blockmean_of_the_full_output(archives, tmp_path,
                                                     depth):
    arch = archives["scales2"]
    full, prev = str(tmp_path / "full"), str(tmp_path / "prev")
    wavelet_tpu_torch.decompress(arch, full, device="cpu")
    wavelet_tpu_torch.decompress(arch, prev, device="cpu", preview=depth,
                                 out_precision="f32")
    for lev in (0, 1):
        a = plotfile.read_level(os.path.join(full, "plt00010"), lev, [0, 1])
        b = plotfile.read_level(os.path.join(prev, "plt00010"), lev, [0, 1])
        for fb, pb in zip(a.boxes, b.boxes):
            assert pb.shape[1:] == tuple(d >> depth for d in fb.shape[1:])
            for c in range(2):
                np.testing.assert_allclose(pb[c], _lowpass_np(fb[c], depth),
                                           rtol=1e-5, atol=1e-6)


def test_cli_preview_runs_and_over_a_mesh(archives, tmp_path):
    arch = archives["scales2"]
    out = str(tmp_path / "cli") + os.sep
    assert cli.main([f"compresseddir={arch}", f"out={out}", "preview=1",
                     "device=cpu", "-d"]) == 0
    mesh = str(tmp_path / "mesh") + os.sep
    assert cli.main([f"compresseddir={arch}", f"out={mesh}", "preview=1",
                     "devices=8", "device=cpu", "-d"]) == 0
    j_decompress(JConfig(compressed_dir=arch, out_dir=str(tmp_path / "j"),
                         preview=1))
    want = tree_bytes(tmp_path / "j")
    assert tree_bytes(out) == want and tree_bytes(mesh) == want


def test_cli_preview_deeper_than_the_boxes_is_a_clean_error(archives,
                                                           tmp_path):
    # the 8^3 boxes do not divide by 2**4
    assert cli.main([f"compresseddir={archives['files']}",
                     f"out={tmp_path / 'o'}", "preview=4", "device=cpu",
                     "-d"]) == 1


_D = ["compresseddir=x", "out=y", "device=cpu", "-d"]


@pytest.mark.parametrize("extra", [["preview=-1"],
                                   ["preview=1", "transfer=sparse"]])
def test_cli_preview_errors_match_jax(extra):
    with pytest.raises(SystemExit) as want:
        jcli.parse_argv(_D + extra)
    with pytest.raises(SystemExit) as got:
        cli.parse_argv(_D + extra)
    assert str(got.value) == str(want.value) and str(got.value)


def test_cli_parses_preview_like_jax():
    _, cfg = cli.parse_argv(_D + ["preview=2", "transfer=auto"])
    _, jcfg = jcli.parse_argv(_D + ["preview=2", "transfer=auto"])
    assert cfg.preview == jcfg.preview == 2
    assert cfg.transfer == jcfg.transfer
