"""The port's device mesh and giant boxes against the JAX package.

``CodecEngine(mesh=data_mesh(["cpu"] * 8))`` splits each batch into eight
row chunks; it must give bitwise what the engine gives without a mesh and
what ``wavelet_tpu``'s engine gives on the conftest's 8-device virtual CPU
mesh (box thresholds, the global histogram, sparse transfer, the halves
route).  Giant boxes are split along X into slabs transformed one per mesh
entry and regrouped on the host (``runtime/distributed``): the regroup is
held bitwise to the whole-box pyramid at D in {2, 4, 8} slabs and scales
1-3, with a tie box and NaN/+-inf boxes, and giant archives to
``wavelet_tpu``'s giant archives (``giant_box_bytes=1 << 17``, mesh8) and
to the unsplit run.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from conftest import tree_bytes  # noqa: E402

from wavelet_tpu import cli as jcli  # noqa: E402
from wavelet_tpu.io import plotfile  # noqa: E402
from wavelet_tpu.pipeline import Config as JConfig  # noqa: E402
from wavelet_tpu.pipeline import compress_run as j_compress  # noqa: E402
from wavelet_tpu.pipeline import decompress_run as j_decompress  # noqa: E402
from wavelet_tpu.pipeline import estimate_run as j_estimate  # noqa: E402
from wavelet_tpu.runtime import batching as jbatching  # noqa: E402
from wavelet_tpu.runtime import engine as jengine  # noqa: E402
from wavelet_tpu.runtime import mesh as jmesh  # noqa: E402
import wavelet_tpu_torch  # noqa: E402
from wavelet_tpu_torch import cli  # noqa: E402
from wavelet_tpu_torch.core import haar  # noqa: E402
from wavelet_tpu_torch.runtime import batching, distributed  # noqa: E402
from wavelet_tpu_torch.runtime import engine  # noqa: E402
from wavelet_tpu_torch.runtime import mesh as mesh_lib  # noqa: E402

CPU8 = mesh_lib.data_mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def mesh8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    return jmesh.data_mesh(devs[:8])


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _boxes(n, dims, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n,) + tuple(dims)) * 50).astype(np.float32)
    x[0] = 0.0
    x[0, 1, 0, 0] = 8.0             # an exact min == -max tie
    return x


def _plan(mod, eng, x):
    items = [mod.WorkItem(t=0, level=0, comp_idx=0, box=b)
             for b in range(len(x))]
    return mod.plan_batches([(it, x[i]) for i, it in enumerate(items)],
                            pad_multiple=8, pack_fn=eng.pack_factor,
                            pad_fn=eng.pad_multiple_for)


def test_mesh_lists_devices_with_repeats():
    m = mesh_lib.data_mesh(["cpu", "cpu"])
    assert m.size == 2 and mesh_lib.DATA_AXIS == "data"
    assert all(d == torch.device("cpu") for d in m.devices)
    with pytest.raises(ValueError, match="at least one"):
        mesh_lib.data_mesh([])
    with pytest.raises(ValueError, match="unsupported device"):
        mesh_lib.data_mesh(["tpu"])


def test_engine_rejects_a_mesh_of_another_device_type(monkeypatch):
    mesh = mesh_lib.data_mesh(["cpu"] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="mesh holds"):
        engine.CodecEngine(device="cuda", mesh=mesh)


@pytest.mark.parametrize("dims,scales", [((8, 8, 8), 1), ((16, 8, 8), 2),
                                         ((9, 6, 5), 1), ((16, 16, 8), 3)])
def test_engine_over_mesh8_matches_itself_and_jax(mesh8, dims, scales):
    x = _boxes(13, dims, sum(dims) + scales)
    port = engine.CodecEngine(device="cpu", scales=scales, mesh=CPU8)
    plain = engine.CodecEngine(device="cpu", scales=scales)
    jeng = jengine.CodecEngine(mesh=mesh8, scales=scales)
    assert port.pad_multiple_for(dims) == jeng.pad_multiple_for(dims) == 8
    [pb] = _plan(batching, port, x)
    [jb] = _plan(jbatching, jeng, x)
    assert pb.data.shape == jb.data.shape == (16,) + dims
    outs = []
    for eng, b in ((port, pb), (plain, pb), (jeng, jb)):
        cb, t32 = eng.compress_shapebatch(b, 0.999)
        hb, hist = eng.forward_hist_shapebatch(b)
        rec = eng.decompress_shapebatch(cb).data
        outs.append((cb.data, t32, hb.data, hist, rec))
    for got in outs[1:]:
        for a, b in zip(outs[0], got):
            np.testing.assert_array_equal(np.asarray(a).view(np.int32)
                                          if a.dtype == np.float32 else a,
                                          np.asarray(b).view(np.int32)
                                          if b.dtype == np.float32 else b)


def test_indivisible_batch_runs_whole_on_the_first_entry():
    x = _boxes(5, (8, 8, 8), 3)
    port = engine.CodecEngine(device="cpu", mesh=CPU8)
    assert port._row_chunks(5) == [(torch.device("cpu"), 0, 5)]
    assert [hi - lo for _, lo, hi in port._row_chunks(16)] == [2] * 8
    flat, signed = port.forward_signed_batch(x)
    pflat, psigned = engine.CodecEngine(device="cpu").forward_signed_batch(x)
    np.testing.assert_array_equal(_bits(flat), _bits(pflat))
    np.testing.assert_array_equal(_bits(signed), _bits(psigned))


@pytest.mark.parametrize("dims,scales", [((16, 16, 16), 1), ((16, 8, 8), 2)])
def test_sparse_over_mesh8_matches_one_device(dims, scales, tmp_path):
    x = _boxes(11, dims, 4)
    x[:, 1:] *= 1e-4
    outs = []
    for mesh in (CPU8, None):
        eng = engine.CodecEngine(device="cpu", scales=scales, mesh=mesh)
        [b] = _plan(batching, eng, x)
        sparse, t32 = eng.compress_shapebatch_sparse(b, 0.999)
        pairs = [sparse.item_pairs(i, float(t32[i])) for i in range(11)]
        packer = engine.HostPacker()
        d = tmp_path / ("mesh" if mesh else "one")
        d.mkdir()
        packer.pack_sparse(str(d), sparse, t32)
        shell = batching.ShapeBatch(shape=dims, data=None, items=b.items,
                                    n_valid=11)
        idx, vals = packer.unpack_sparse(str(d), shell)
        rec = eng.decompress_shapebatch_sparse(shell, idx, vals)
        outs.append((t32[:11], sparse.counts[:11], pairs,
                     np.stack([rec.item_view(i) for i in range(11)])))
    (t, c, p, r), (ot, oc, op, orr) = outs
    np.testing.assert_array_equal(_bits(t), _bits(ot))
    np.testing.assert_array_equal(c, oc)
    for (a, b), (oa, ob) in zip(p, op):
        np.testing.assert_array_equal(a, oa)
        np.testing.assert_array_equal(_bits(b), _bits(ob))
    np.testing.assert_array_equal(_bits(r), _bits(orr))


def test_halves_route_over_mesh8_matches_one_device():
    n = 24
    x = _boxes(n, (4, 8, 16), 6)
    outs = []
    for mesh, rows in ((CPU8, 8), (None, 3)):
        eng = engine.CodecEngine(device="cpu", layout="halves", mesh=mesh)
        [b] = _plan(batching, eng, x)
        assert b.pack == 8 and b.data.shape[0] == rows
        cb, t32 = eng.compress_shapebatch(b, 0.999)
        _, hist = eng.forward_hist_shapebatch(b)
        sparse, _ = eng.compress_shapebatch_sparse(b, 0.999)
        rec = eng.decompress_shapebatch(cb)
        outs.append((np.stack([cb.item_view(i) for i in range(n)]),
                     t32[:n], hist, sparse.counts[:n],
                     np.stack([rec.item_view(i) for i in range(n)])))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# ---- giant boxes ---------------------------------------------------------

def _special_box(dims, seed):
    x = _boxes(2, dims, seed)[1]
    x[3, 2, 1] = np.nan
    x[5, 0, 4] = np.inf
    x[-1, -1, -1] = -np.inf
    return x


GIANT_BOXES = {
    "normal": lambda dims: _boxes(2, dims, 21)[1],
    "tie": lambda dims: _boxes(2, dims, 22)[0],
    "nan_inf": lambda dims: _special_box(dims, 23),
}


@pytest.mark.parametrize("kind", list(GIANT_BOXES))
@pytest.mark.parametrize("scales", [1, 2, 3])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_giant_assembly_is_the_whole_box_pyramid(d, scales, kind):
    dims = (64, 16, 8)
    box = GIANT_BOXES[kind](dims)
    mesh = mesh_lib.data_mesh(["cpu"] * d)
    whole = haar.haar3d_forward_multi(torch.from_numpy(box[None]),
                                      scales).numpy()[0]
    coeffs, mx, mn = distributed.sharded_box_forward(mesh, box, scales)
    np.testing.assert_array_equal(_bits(coeffs), _bits(whole))
    flat = torch.from_numpy(whole.reshape(1, -1))
    np.testing.assert_array_equal(_bits(mx), _bits(flat.amax(dim=1)[0]))
    np.testing.assert_array_equal(_bits(mn), _bits(flat.amin(dim=1)[0]))
    slabs = distributed.split(coeffs, d, scales)
    np.testing.assert_array_equal(
        _bits(distributed.assemble(slabs, scales)), _bits(coeffs))
    rec = distributed.sharded_box_inverse(mesh, coeffs, scales)
    want = haar.haar3d_inverse_multi(torch.from_numpy(whole[None]),
                                     scales).numpy()[0]
    np.testing.assert_array_equal(_bits(rec), _bits(want))
    _, hist = distributed.sharded_box_forward_hist(mesh, box, scales,
                                                   fetch_coeffs=False)
    eng = engine.CodecEngine(device="cpu", scales=scales)
    _, phist = eng._forward_hist(box[None])
    np.testing.assert_array_equal(hist, phist)


@pytest.mark.parametrize("kind", ["normal", "tie"])
@pytest.mark.parametrize("scales", [1, 2])
def test_giant_engine_matches_unsplit_and_jax(mesh8, scales, kind):
    dims = (64, 32, 32)
    box = GIANT_BOXES[kind](dims)
    giant = engine.CodecEngine(device="cpu", scales=scales, mesh=CPU8,
                               giant_box_bytes=1 << 17)
    plain = engine.CodecEngine(device="cpu", scales=scales)
    jeng = jengine.CodecEngine(mesh=mesh8, scales=scales,
                               giant_box_bytes=1 << 17)
    assert giant.giant_ok(dims) and jeng.giant_ok(dims)
    assert not plain.giant_ok(dims)
    [gb] = _plan(batching, giant, box[None])
    [pb] = _plan(batching, plain, box[None])
    [jb] = _plan(jbatching, jeng, box[None])
    assert gb.data.shape[0] == 1          # no phantom giant boxes
    gcb, gt = giant.compress_shapebatch(gb, 0.999)
    pcb, pt = plain.compress_shapebatch(pb, 0.999)
    jcb, jt = jeng.compress_shapebatch(jb, 0.999)
    np.testing.assert_array_equal(_bits(gcb.item_view(0)),
                                  _bits(pcb.item_view(0)))
    # the JAX package's giant coefficients are interleaved, so they are
    # held through their thresholds, histogram and reconstruction
    np.testing.assert_array_equal(_bits(gt[:1]), _bits(pt[:1]))
    np.testing.assert_array_equal(_bits(gt[:1]), _bits(jt[:1]))
    _, ghist = giant.forward_hist_shapebatch(gb)
    _, jhist = jeng.forward_hist_shapebatch(jb)
    np.testing.assert_array_equal(ghist, jhist)
    np.testing.assert_array_equal(
        _bits(giant.decompress_shapebatch(gcb).item_view(0)),
        _bits(jeng.decompress_shapebatch(jcb).item_view(0)))


@pytest.mark.parametrize("dims,scales", [
    ((64, 64, 64), 1), ((32, 32, 32), 1), ((40, 256, 128), 1),
    ((64, 64, 64), 2), ((40, 128, 128), 2), ((64, 32, 8), 3),
    ((64, 32, 4), 3), ((17, 64, 64), 1)])
def test_giant_gate_matches_jax(mesh8, dims, scales):
    port = engine.CodecEngine(device="cpu", scales=scales, mesh=CPU8,
                              giant_box_bytes=1 << 17)
    jeng = jengine.CodecEngine(mesh=mesh8, scales=scales,
                               giant_box_bytes=1 << 17)
    assert port.giant_ok(dims) == jeng.giant_ok(dims)
    assert port.pad_multiple_for(dims) == jeng.pad_multiple_for(dims)
    assert port.transfer_mode(dims, "sparse") == jeng.transfer_mode(
        dims, "sparse")


def test_giant_deep_preview_raises_and_corner_runs():
    dims = (64, 32, 32)
    eng = engine.CodecEngine(device="cpu", mesh=CPU8,
                             giant_box_bytes=1 << 17)
    batch = batching.ShapeBatch(shape=dims,
                                data=np.zeros((1,) + dims, np.float32),
                                items=[batching.WorkItem(0, 0, 0, 0)],
                                n_valid=1)
    with pytest.raises(ValueError, match="giant"):
        eng.preview_shapebatch(batch, 2)
    out, _ = eng.preview_shapebatch(batch, 1)
    assert out.shape == (1, 32, 16, 16)
    with pytest.raises(ValueError, match="giant"):
        eng.compress_shapebatch_sparse(batch, 0.999)


# ---- pipelines -----------------------------------------------------------

def _field(shape, t, q, rng):
    x, y, z = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    f = (np.tanh((x + 0.5 * y - 0.3 * z - 5.0 + 2.0 * t) / 1.5)
         + 0.2 * np.sin(0.4 * y + q) + 0.01 * rng.standard_normal(shape))
    return ((1.0 + q) * f).astype(np.float32)


def _write_data(root: str) -> str:
    """Two timesteps mixing one 64^3 box (1 MiB: giant at 1 << 17) with
    even, odd and small shapes."""
    rng = np.random.default_rng(13)
    data = os.path.join(root, "data")
    l0 = [((0, 0, 0), (64, 64, 64)), ((64, 0, 0), (16, 8, 8)),
          ((80, 0, 0), (8, 8, 8)), ((0, 64, 0), (9, 6, 5)),
          ((16, 64, 0), (8, 4, 2))]
    for t, name in enumerate(["plt00010", "plt00020"]):
        boxes = [[np.stack([_field(d, t, q, rng) for q in range(2)])
                  for _, d in l0]]
        plotfile.write_plotfile(
            os.path.join(data, name), boxes, [[loc for loc, _ in l0]],
            [[d for _, d in l0]], ["a", "b"], 0.5 + t, [0.0, 0.0, 0.0],
            [1.0, 1.0, 1.0], (2, 2, 2), (96, 80, 64), [10 * (t + 1)],
            precision="f32")
    return data


PIPE = {
    "box": {},
    "global": {"threshold_mode": "global", "keep_fraction": 0.02,
               "scales": 2},
    "sparse": {"transfer": "sparse"},
    "bundle_scales2": {"archive": "bundle", "scales": 2},
}


def _cargs(data, comp, **kw):
    return dict(data_dir=data, min_time="plt00010", max_time="plt00020",
                min_level=0, max_level=0, components=["a", "b"], keep=0.999,
                compressed_dir=comp, **kw)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _write_data(str(tmp_path_factory.mktemp("torch_mesh")))


@pytest.mark.parametrize("giant", [False, True], ids=["mesh8", "giant"])
@pytest.mark.parametrize("variant", list(PIPE))
def test_archives_over_mesh8_match_jax_and_one_device(data, mesh8, tmp_path,
                                                      variant, giant):
    kw = dict(PIPE[variant])
    if giant:
        kw["giant_box_bytes"] = 1 << 17
    j_arch = str(tmp_path / "j") + os.sep
    j_compress(JConfig(**_cargs(data, j_arch, **kw)), mesh=mesh8)
    archs = {}
    for name, mesh in (("mesh", CPU8), ("one", None)):
        archs[name] = str(tmp_path / name) + os.sep
        wavelet_tpu_torch.compress(
            data, archs[name], min_time="plt00010", max_time="plt00020",
            components=["a", "b"], min_level=0, max_level=0, keep=0.999,
            device="cpu", mesh=mesh, **kw)
    want = tree_bytes(j_arch)
    assert len(want) > 5
    assert tree_bytes(archs["mesh"]) == want
    assert tree_bytes(archs["one"]) == want
    # -d over the mesh (and giant boxes split again) gives the one-device
    # and the JAX package's plotfiles
    d_kw = {k: v for k, v in kw.items() if k in ("giant_box_bytes",
                                                 "transfer")}
    j_decompress(JConfig(compressed_dir=j_arch, out_dir=str(tmp_path / "jo"),
                         **d_kw), mesh=mesh8)
    wavelet_tpu_torch.decompress(archs["mesh"], str(tmp_path / "to"),
                                 device="cpu", mesh=CPU8, **d_kw)
    out = tree_bytes(tmp_path / "jo")
    assert len(out) == 2 * 3
    assert tree_bytes(tmp_path / "to") == out


def test_giant_estimate_matches_unsplit_and_jax(data, mesh8):
    base = dict(min_time="plt00010", components=["a", "b"], keep=0.999)
    got = wavelet_tpu_torch.estimate(data, device="cpu", mesh=CPU8,
                                     giant_box_bytes=1 << 17, **base)
    plain = wavelet_tpu_torch.estimate(data, device="cpu", **base)
    fast = wavelet_tpu_torch.estimate(data, device="cpu", mesh=CPU8,
                                      giant_box_bytes=1 << 17,
                                      fast_estimate=True, **base)
    want = j_estimate(JConfig(data_dir=data, max_time="plt00010",
                              min_level=0, max_level=0,
                              giant_box_bytes=1 << 17, **base), mesh=mesh8)
    assert got == plain == fast == want


def test_cli_devices_and_giantbox_run_like_jax(data, mesh8, tmp_path):
    base = [f"datadir={data}", "minfile=plt00010", "maxfile=plt00020",
            "minlevel=0", "maxlevel=0", "components=a b", "keep=0.999",
            "scales=2", "archive=bundle"]
    arch = str(tmp_path / "arch") + os.sep
    assert cli.main(base + [f"compresseddir={arch}", "devices=8",
                            "giantbox=131072", "device=cpu", "-c"]) == 0
    j_arch = str(tmp_path / "j") + os.sep
    assert jcli.main(base + [f"compresseddir={j_arch}", "devices=8",
                             "giantbox=131072", "-c"]) == 0
    assert tree_bytes(arch) == tree_bytes(j_arch)
    out = str(tmp_path / "out") + os.sep
    assert cli.main([f"compresseddir={arch}", f"out={out}", "devices=8",
                     "giantbox=131072", "device=cpu", "-d"]) == 0
    j_out = str(tmp_path / "jo") + os.sep
    assert jcli.main([f"compresseddir={j_arch}", f"out={j_out}",
                      "-d"]) == 0
    assert tree_bytes(out) == tree_bytes(j_out)


def test_cli_devices_beyond_the_cards_is_jax_s_error(monkeypatch, caplog):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError,
                       match=r"^devices=2 but only 1 device\(s\) available$"):
        cli._mesh("cuda", 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["compresseddir=x", "out=y", "devices=2", "-d"]) == 1
    assert "devices=2 but only 0 device(s) available" in caplog.text
    assert cli._mesh("cpu", 1) is None
    assert cli._mesh("cpu", 3).size == 3


@pytest.mark.parametrize("rank,cards,want", [(0, 4, [0, 1]), (1, 4, [2, 3]),
                                             (1, 3, [2, 3])])
def test_cli_devices_mesh_is_offset_by_rank(monkeypatch, rank, cards, want):
    # processes=P devices=N on one host: each process takes its own N
    # cards, as devices=1 spreads the processes by rank; cards the host
    # does not have are refused, never wrapped onto another rank's
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(mesh_lib, "process_index", lambda: rank)
    if max(want) >= cards:
        with pytest.raises(ValueError, match="this host has 3 card"):
            cli._mesh("cuda", 2)
        return
    assert [d.index for d in cli._mesh("cuda", 2).devices] == want


_C = ["datadir=x", "minfile=a", "maxfile=b", "minlevel=0", "maxlevel=0",
      "components=temp", "keep=0.9", "compresseddir=y", "device=cpu", "-c"]


@pytest.mark.parametrize("extra", [["giantbox=0"], ["giantbox=-5"],
                                   ["giantmesh=both"]])
def test_cli_giant_key_errors_match_jax(extra):
    with pytest.raises(SystemExit) as want:
        jcli.parse_argv(_C + extra)
    with pytest.raises(SystemExit) as got:
        cli.parse_argv(_C + extra)
    assert str(got.value) == str(want.value) and str(got.value)


def test_cli_parses_giantbox_like_jax():
    for argv in (_C, ["compresseddir=x", "out=y", "-d"]):
        _, cfg = cli.parse_argv(argv + ["giantbox=4096"])
        _, jcfg = jcli.parse_argv(argv + ["giantbox=4096"])
        assert cfg.giant_box_bytes == jcfg.giant_box_bytes == 4096


def test_profile_writes_a_chrome_trace(data, tmp_path):
    trace = tmp_path / "trace"
    assert cli.main([f"datadir={data}", "minfile=plt00010",
                     "maxfile=plt00010", "minlevel=0", "maxlevel=0",
                     "components=a", "keep=0.999", "device=cpu",
                     f"compresseddir={tmp_path / 'arch'}",
                     f"profile={trace}", "-c"]) == 0
    assert os.listdir(trace) == ["trace_p0.json"]
    assert (trace / "trace_p0.json").stat().st_size > 0
