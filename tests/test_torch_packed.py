"""The lane-packed halves route (``WAVELET_TPU_LAYOUT=halves``) in the port,
against the JAX package, on the CPU.

On the CPU the packed wrappers run their plain PyTorch versions; these are
held bitwise (int32 views) to the Pallas kernels K3
``haar_pallas._fused_forward_packed_call`` and K4
``_fused_inverse_packed_call`` in interpret mode, as
tests/test_packed_path.py runs them.  A zero extremum may be +0.0 from one
and -0.0 from the other (its sign cannot change ``|c| > t32``).  The
engine on the halves route is held to JAX's ``CodecEngine(use_pallas=True,
layout="halves")``, and archives written under ``WAVELET_TPU_LAYOUT=halves``
must be byte-identical to the default layout's and to ``wavelet_tpu``'s.
The kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import contextlib
import os
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from conftest import tree_bytes  # noqa: E402

from wavelet_tpu.core import threshold as jthreshold  # noqa: E402
from wavelet_tpu.kernels import haar_pallas as hp  # noqa: E402
from wavelet_tpu.pipeline import Config as JConfig  # noqa: E402
from wavelet_tpu.pipeline import compress_run as j_compress  # noqa: E402
from wavelet_tpu.pipeline import decompress_run as j_decompress  # noqa: E402
from wavelet_tpu.runtime import batching as jbatching  # noqa: E402
from wavelet_tpu.runtime import engine as jengine  # noqa: E402
import wavelet_tpu_torch  # noqa: E402
from wavelet_tpu_torch.io import plotfile  # noqa: E402
from wavelet_tpu_torch.kernels import haar_cuda, packed_cuda  # noqa: E402
from wavelet_tpu_torch.runtime import batching, engine  # noqa: E402

# (dims, P): P = 128 / Z, but for the odd X/Y case
KERNEL_CASES = [((4, 8, 16), 8), ((5, 3, 16), 8), ((8, 4, 2), 64),
                ((16, 32, 64), 2)]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _same(got, want):
    """Bitwise, with NaN equal to NaN and +0.0 equal to -0.0 (extrema)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    same = ((_bits(got) == _bits(want)) | (np.isnan(got) & np.isnan(want))
            | ((got == 0) & (want == 0)))
    assert same.all(), (got[~same][:8], want[~same][:8])


def _boxes(dims, pack, seed, rows=2, special=False):
    rng = np.random.default_rng(seed)
    b = (rng.standard_normal((pack * rows,) + tuple(dims)) * 50).astype(
        np.float32)
    if special:
        b[0, 0, 0, 1] = np.nan
        b[1, -1, -1, -1] = np.inf
        b[1, 0, 0, 0] = -np.inf
        b[2] = 0.0
        b[2, min(1, dims[0] - 1), 0, 0] = 8.0   # a min == -max tie box
        b[3] = 0.0
    return b


def _packed(boxes, pack):
    n, x, y, z = boxes.shape
    return np.ascontiguousarray(
        boxes.reshape(n // pack, pack, x, y, z).transpose(0, 2, 3, 1, 4)
        .reshape(n // pack, x, y, pack * z))


@contextlib.contextmanager
def _flush_denormal():
    assert torch.set_flush_denormal(True), "CPU cannot flush denormals"
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _layout(value):
    return mock.patch.dict(os.environ, {"WAVELET_TPU_LAYOUT": value})


# ---- the plain versions against K3/K4 in interpret mode -------------------

@pytest.mark.parametrize("dims", [(16, 32, 64), (8, 4, 2), (4, 4, 128),
                                  (4, 4, 256), (5, 5, 3), (4, 4, 6),
                                  (2, 2, 32)])
def test_lane_pack_factor_matches_jax(dims):
    assert packed_cuda.lane_pack_factor(dims) == hp.lane_pack_factor(dims)


def test_lane_pack_factor_values():
    assert packed_cuda.lane_pack_factor((16, 32, 64)) == 2
    assert packed_cuda.lane_pack_factor((8, 4, 2)) == 64
    assert packed_cuda.lane_pack_factor((4, 4, 128)) == 1
    assert packed_cuda.lane_pack_factor((5, 5, 3)) == 1   # odd Z unpacked


@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("dims,pack", KERNEL_CASES)
def test_packed_forward_plain_matches_k3_interpret(dims, pack, special):
    x = _packed(_boxes(dims, pack, 1, special=special), pack)
    c, mx, mn = packed_cuda.packed_forward(torch.from_numpy(x), pack)
    jc, jmx, jmn = hp._fused_forward_packed_call(jnp.asarray(x.copy()), pack,
                                                 interpret=True)
    _same(c, jc)
    if not special:
        np.testing.assert_array_equal(_bits(c), _bits(jc))
    _same(mx, jmx)
    _same(mn, jmn)
    if special:
        assert np.isnan(float(mx[0])) and np.isnan(float(mn[0]))
        assert float(mx[2]) == 1.0 and float(mn[2]) == -1.0


@pytest.mark.parametrize("dims,pack", KERNEL_CASES)
def test_packed_inverse_plain_matches_k4_interpret(dims, pack):
    c = _packed(_boxes(dims, pack, 2), pack)
    got = packed_cuda.packed_inverse(torch.from_numpy(c), pack)
    want = hp._fused_inverse_packed_call(jnp.asarray(c.copy()), pack,
                                         interpret=True)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the packed round trip is the unpacked one, box by box (odd X/Y
    # tails come back zeroed, as the reference's inverse leaves them)
    boxes = _boxes(dims, pack, 3)
    fwd = packed_cuda.packed_forward(torch.from_numpy(_packed(boxes, pack)),
                                     pack)[0]
    back = packed_cuda.packed_inverse(fwd, pack)
    ref = haar_cuda.fused_inverse(
        haar_cuda.fused_forward(torch.from_numpy(boxes))[0])
    np.testing.assert_array_equal(_bits(back),
                                  _bits(_packed(ref.numpy(), pack)))


@pytest.mark.parametrize("dims,pack", [((4, 8, 16), 8), ((5, 3, 16), 8)])
def test_packed_subnormals_match_jax_under_its_flush(dims, pack):
    b = (_boxes(dims, pack, 4) * np.float32(1e-39)).astype(np.float32)
    b.reshape(-1)[::3] *= np.float32(1e-5)
    x = _packed(b, pack)
    jc, jmx, jmn = hp._fused_forward_packed_call(jnp.asarray(x.copy()), pack,
                                                 interpret=True)
    with _flush_denormal():
        c, mx, mn = packed_cuda.packed_forward(torch.from_numpy(x), pack)
        inv = packed_cuda.packed_inverse(torch.from_numpy(np.array(jc)),
                                         pack)
    np.testing.assert_array_equal(_bits(c), _bits(jc))
    _same(mx, jmx)
    _same(mn, jmn)
    jinv = hp._fused_inverse_packed_call(jnp.asarray(np.asarray(jc)), pack,
                                         interpret=True)
    np.testing.assert_array_equal(_bits(inv), _bits(jinv))


@pytest.mark.parametrize("dims,pack", KERNEL_CASES)
def test_packed_forward_hist_plain_is_histogram_of_unpacked(dims, pack):
    x = _packed(_boxes(dims, pack, 5), pack)
    c, hist = packed_cuda.packed_forward_hist(torch.from_numpy(x), pack)
    jc, _, _ = hp._fused_forward_packed_call(jnp.asarray(x.copy()), pack,
                                             interpret=True)
    np.testing.assert_array_equal(_bits(c), _bits(jc))
    logical = packed_cuda.unpack(torch.from_numpy(np.array(jc)), pack)
    want = np.asarray(jthreshold.abs_exponent_histogram(
        jnp.asarray(logical.numpy())), np.int64)
    np.testing.assert_array_equal(hist.numpy(), want)


def test_packed_wrappers_check_inputs_and_count_nothing_on_cpu():
    before = dict(packed_cuda.launches)
    x = torch.zeros((2, 4, 4, 32))
    packed_cuda.packed_inverse(packed_cuda.packed_forward(x, 2)[0], 2)
    packed_cuda.packed_forward_hist(x, 2)
    assert packed_cuda.launches == before
    with pytest.raises(ValueError, match="even Z"):
        packed_cuda.packed_forward(torch.zeros((2, 4, 4, 30)), 2)  # Z = 15
    with pytest.raises(ValueError, match="even Z"):
        packed_cuda.packed_inverse(torch.zeros((2, 4, 4, 30)), 4)
    with pytest.raises(TypeError):
        packed_cuda.packed_forward(torch.zeros((2, 4, 4, 32),
                                               dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="contiguous"):
        packed_cuda.packed_forward(torch.zeros((2, 4, 32, 4)).transpose(2, 3),
                                   2)


# ---- the engine on the halves route against JAX's -------------------------

def _entries(mod, n, dims, seed):
    rng = np.random.default_rng(seed)
    out = [(mod.WorkItem(0, 0, 0, i),
            (rng.standard_normal(dims) * 20).astype(np.float32))
           for i in range(n)]
    if n > 2:
        tie = np.zeros(dims, np.float32)
        tie[min(1, dims[0] - 1), 0, 0] = 8.0   # |min| == |max|: first wins
        out[2] = (out[2][0], tie)
    return out


@pytest.mark.parametrize("dims,n", [((4, 8, 16), 5), ((8, 4, 2), 3),
                                    ((5, 3, 16), 9)])
def test_engine_halves_route_matches_jax(dims, n):
    eng = engine.CodecEngine(device="cpu", layout="halves")
    jeng = jengine.CodecEngine(use_pallas=True, layout="halves")
    [pb] = batching.plan_batches(_entries(batching, n, dims, 6),
                                 pack_fn=eng.pack_factor)
    [jb] = jbatching.plan_batches(_entries(jbatching, n, dims, 6),
                                  pack_fn=jeng.pack_factor)
    assert pb.pack == jb.pack == hp.lane_pack_factor(dims) > 1
    cb, t32 = eng.compress_shapebatch(pb, 0.99)
    jcb, jt32 = jeng.compress_shapebatch(jb, 0.99)
    np.testing.assert_array_equal(_bits(t32), _bits(jt32))
    np.testing.assert_array_equal(_bits(cb.data), _bits(jcb.data))
    assert t32[2] > 0          # the tie box resolved to +1, not -1
    out = eng.decompress_shapebatch(cb)
    jout = jeng.decompress_shapebatch(jcb)
    assert out.pack == pb.pack
    np.testing.assert_array_equal(_bits(out.data), _bits(jout.data))
    hb, hist = eng.forward_hist_shapebatch(pb)
    jhb, jhist = jeng.forward_hist_shapebatch(jb)
    np.testing.assert_array_equal(_bits(hb.data), _bits(jhb.data))
    np.testing.assert_array_equal(hist, jhist)
    # padding taken out of the zero bin per item, not per packed row
    assert int(hist.sum()) == n * int(np.prod(dims))
    sparse, st32 = eng.compress_shapebatch_sparse(pb, 0.99)
    jsparse, jst32 = jeng.compress_shapebatch_sparse(jb, 0.99)
    np.testing.assert_array_equal(_bits(st32), _bits(jst32))
    np.testing.assert_array_equal(sparse.counts, jsparse.counts)
    for i in range(n):
        a, b = sparse.item_pairs(i, float(st32[i]))
        ja, jb_ = jsparse.item_pairs(i, float(jst32[i]))
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(_bits(b), _bits(jb_))


def test_histogram_padding_counted_per_item():
    """Three items packed eight to a row: five padding items, not the
    seven padding rows a per-row count would take out of the zero bin."""
    dims = (4, 8, 16)
    eng = engine.CodecEngine(device="cpu", layout="halves")
    [pb] = batching.plan_batches(_entries(batching, 3, dims, 7),
                                 pack_fn=eng.pack_factor)
    assert pb.pack == 8 and pb.data.shape[0] == 1
    _, hist = eng.forward_hist_shapebatch(pb, fetch_coeffs=False)
    ref = engine.CodecEngine(device="cpu")
    [ub] = batching.plan_batches(_entries(batching, 3, dims, 7),
                                 pack_fn=ref.pack_factor)
    _, want = ref.forward_hist_shapebatch(ub, fetch_coeffs=False)
    np.testing.assert_array_equal(hist, want)
    assert int(hist.sum()) == 3 * 4 * 8 * 16


@pytest.mark.parametrize("layout,dims,scales,want", [
    ("auto", (16, 32, 64), 1, 1), ("interleaved", (16, 32, 64), 1, 1),
    ("halves", (16, 32, 64), 1, 2), ("halves", (8, 4, 2), 1, 64),
    ("halves", (16, 32, 64), 2, 1),      # pyramids keep the unpacked kernels
    ("halves", (5, 5, 3), 1, 1),         # odd Z
    ("halves", (128, 128, 64), 1, 2),    # exactly 4 MiB
    ("halves", (256, 128, 64), 1, 1),    # past the 4 MiB halves bound
])
def test_pack_factor_follows_jax(layout, dims, scales, want):
    eng = engine.CodecEngine(device="cpu", scales=scales, layout=layout)
    assert eng.pack_factor(dims) == want
    jeng = jengine.CodecEngine(use_pallas=True, scales=scales,
                               layout="halves" if layout == "halves"
                               else "interleaved")
    if layout == "halves":
        assert jeng.pack_factor(dims) == want
    with _layout(layout):
        assert engine.CodecEngine(device="cpu",
                                  scales=scales).pack_factor(dims) == want


def test_unknown_layout_raises_and_default_refuses_packed_batches():
    with pytest.raises(ValueError, match="layout"):
        engine.CodecEngine(device="cpu", layout="diagonal")
    dims = (4, 8, 16)
    [pb] = batching.plan_batches(_entries(batching, 2, dims, 8),
                                 pack_fn=lambda s: 8)
    with pytest.raises(NotImplementedError, match="pack=8"):
        engine.CodecEngine(device="cpu").compress_shapebatch(pb, 0.99)


@pytest.mark.parametrize("native", [True, False])
def test_packer_walks_packed_batches(tmp_path, native):
    """pack / unpack_into on packed batches equal the pack=1 walk, with
    the native strided codec and with the Python item views."""
    from wavelet_tpu_torch import native as native_mod

    if native and not native_mod.available():
        pytest.skip("native codec not built")
    dims = (4, 8, 16)
    eng = engine.CodecEngine(device="cpu", layout="halves")
    entries = _entries(batching, 5, dims, 9)
    [pb] = batching.plan_batches(entries, pack_fn=eng.pack_factor)
    [ub] = batching.plan_batches(entries)
    cb, t32 = eng.compress_shapebatch(pb, 0.99)
    ucb, ut32 = engine.CodecEngine(device="cpu").compress_shapebatch(ub, 0.99)
    packer = engine.HostPacker(use_native=native)
    (tmp_path / "p").mkdir()
    (tmp_path / "u").mkdir()
    packer.pack(str(tmp_path / "p"), cb, t32)
    packer.pack(str(tmp_path / "u"), ucb, ut32)
    assert tree_bytes(tmp_path / "p") == tree_bytes(tmp_path / "u")
    dest = batching.empty_batch(pb.items, dims, pack=8)
    packer.unpack_into(str(tmp_path / "p"), dest)
    for i in range(5):
        want = np.where(np.abs(ucb.item_view(i)) > ut32[i],
                        ucb.item_view(i), 0.0)
        np.testing.assert_array_equal(_bits(dest.item_view(i)), _bits(want))


# ---- archives under WAVELET_TPU_LAYOUT=halves ------------------------------

COMPS = ["density", "temp"]
STEPS = dict(min_time="plt00010", max_time="plt00020")
VARIANTS = {
    "default": {},
    "global": {"threshold_mode": "global", "keep_fraction": 0.02},
    "sparse": {"transfer": "sparse"},
    "bundle": {"archive": "bundle"},
    "q16": {"payload": "q16"},
}
# Z of 16, 2 and 8 pack (P = 8, 64, 16); Z = 3 and 5 do not
SHAPES = [[((0, 0, 0), (16, 16, 16)), ((16, 0, 0), (16, 16, 16))],
          [((0, 0, 0), (7, 5, 3)), ((8, 0, 0), (8, 4, 2)),
           ((16, 0, 0), (16, 8, 8)), ((0, 16, 0), (5, 3, 16)),
           ((8, 16, 0), (6, 6, 5))]]


def _write_data(root: str) -> str:
    rng = np.random.default_rng(13)
    data = os.path.join(root, "data")
    for t, name in enumerate(["plt00010", "plt00020"]):
        boxes = []
        for lev in SHAPES:
            per = []
            for _, d in lev:
                x, y, z = np.meshgrid(*[np.arange(n) for n in d],
                                      indexing="ij")
                f = (np.tanh((x + 0.25 * y - 5.0 - 2.0 * t) / 0.5)
                     + 1e-4 * rng.standard_normal(d))
                per.append(np.stack([((1.0 + q) * f).astype(np.float32)
                                     for q in range(2)]))
            boxes.append(per)
        plotfile.write_plotfile(
            os.path.join(data, name), boxes,
            [[loc for loc, _ in lev] for lev in SHAPES],
            [[d for _, d in lev] for lev in SHAPES],
            COMPS, 0.5 + t, [0.0, 0.0, 0.0], [1.0, 0.5, 0.5], (2, 2, 2),
            (32, 16, 16), [10 * (t + 1), 20 * (t + 1)])
    return data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per variant: the JAX package's archive and plotfiles, and the
    port's archives at the default layout and under halves."""
    root = str(tmp_path_factory.mktemp("torch_packed"))
    data = _write_data(root)
    out = {"data": data}
    for name, kw in VARIANTS.items():
        d = os.path.join(root, name)
        j_compress(JConfig(data_dir=data, min_level=0, max_level=1,
                           components=list(COMPS), keep=0.999,
                           compressed_dir=d + "/jax/", **STEPS, **kw))
        j_decompress(JConfig(compressed_dir=d + "/jax/",
                             out_dir=d + "/jax_out/"))
        for layout in ("auto", "halves"):
            with _layout(layout):
                wavelet_tpu_torch.compress(
                    data, d + f"/{layout}/", components=COMPS, min_level=0,
                    max_level=1, keep=0.999, device="cpu", **STEPS, **kw)
        out[name] = d
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_halves_archives_byte_identical(runs, variant):
    d = runs[variant]
    want = tree_bytes(d + "/jax/")
    assert len(want) > 5
    assert tree_bytes(d + "/auto/") == want
    assert tree_bytes(d + "/halves/") == want


@pytest.mark.parametrize("transfer", ["dense", "sparse"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_halves_decompress_byte_identical(runs, variant, transfer, tmp_path):
    d = runs[variant]
    out = str(tmp_path / "out") + os.sep
    with _layout("halves"):
        wavelet_tpu_torch.decompress(d + "/halves/", out, device="cpu",
                                     transfer=transfer)
    want = tree_bytes(d + "/jax_out/")
    assert len(want) == 10 and tree_bytes(out) == want


def _count_calls(monkeypatch):
    calls = {}
    for mod, names in ((packed_cuda, ("packed_forward", "packed_inverse",
                                      "packed_forward_hist")),
                       (haar_cuda, ("fused_forward", "fused_inverse"))):
        for name in names:
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **k)
            monkeypatch.setattr(mod, name, counted)
    return calls


def test_halves_route_runs_the_packed_functions(runs, tmp_path,
                                                monkeypatch):
    """Every bucket whose Z packs goes through the packed functions (4 per
    timestep: Z = 16, 2, 8 and 16); the Z = 3 and 5 buckets keep K1/K2."""
    calls = _count_calls(monkeypatch)
    monkeypatch.setenv("WAVELET_TPU_LAYOUT", "halves")
    arch = str(tmp_path / "arch") + os.sep
    wavelet_tpu_torch.compress(runs["data"], arch, components=COMPS,
                               min_level=0, max_level=1, keep=0.999,
                               device="cpu", **STEPS)
    wavelet_tpu_torch.decompress(arch, str(tmp_path / "out"), device="cpu")
    assert calls == {"packed_forward": 8, "fused_forward": 4,
                     "packed_inverse": 8, "fused_inverse": 4}
    calls.clear()
    wavelet_tpu_torch.compress(runs["data"], str(tmp_path / "g"),
                               components=COMPS, min_level=0, max_level=1,
                               threshold_mode="global", keep_fraction=0.02,
                               device="cpu", **STEPS)
    assert calls == {"packed_forward_hist": 8}
