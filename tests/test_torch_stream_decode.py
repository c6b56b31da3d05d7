"""Streamed decode in regen (``pipeline/decompress._stream_rows``,
``runtime/engine.UnpackStream``).

A shape bucket of many dense, unpacked boxes decodes largest member first
on the packer's pool, and its device stage and assemble run a chunk of
rows at a time while the later chunks decode.  The regenerated boxes must
equal the one-shot path's bit for bit, in both archive layouts; buckets of
lane-packed boxes, giant, sparse and preview buckets and buckets under two
chunks keep the one-shot path; a corrupt member raises the one-shot path's
``ValueError`` and leaves no decode thread behind; and the counters say
how much of the device stage ran under the decode.

The packer has two workers; ``_STREAM_MIN_CHUNK_BYTES`` is 0 unless a test
says otherwise, so that a bucket of 24 members of 32^3 is twelve chunks.
"""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import wavelet_tpu_torch  # noqa: E402
from wavelet_tpu_torch.io import bundle, plotfile  # noqa: E402
from wavelet_tpu_torch.pipeline import common, decompress  # noqa: E402
from wavelet_tpu_torch.runtime import batching, engine  # noqa: E402

COMPS = ["density", "temp"]
MODES = ["files", "bundle"]
WORKERS = 2
N_BOX = 12          # boxes of 32^3 in the one-bucket dataset
OFF = 1 << 62       # a minimum chunk no bucket reaches: the one-shot path


class _Packer(engine.HostPacker):
    def __init__(self, *a, **k):
        k["workers"] = WORKERS
        super().__init__(*a, **k)


def _write(root, level_boxes, base):
    """One timestep of the given per-level ``[(location, dims)]`` boxes."""
    rng = np.random.default_rng(7)
    data = os.path.join(root, "data")
    boxes = [[rng.standard_normal((len(COMPS),) + d).astype(np.float32)
              .cumsum(axis=1) for _, d in lev] for lev in level_boxes]
    plotfile.write_plotfile(
        os.path.join(data, "plt00010"), boxes,
        [[loc for loc, _ in lev] for lev in level_boxes],
        [[d for _, d in lev] for lev in level_boxes],
        COMPS, 0.5, [0.0, 0.0, 0.0], [1.0, 1.0, 1.0], (2, 2, 2), base,
        [10 * (i + 1) for i in range(len(level_boxes))])
    return data


def _compress(data, out, mode, levels=1):
    wavelet_tpu_torch.compress(
        data, out, min_time="plt00010", max_time="plt00010",
        components=COMPS, min_level=0, max_level=levels - 1, keep=0.999,
        device="cpu", archive=mode)


def _regen(archive, min_chunk_bytes=0, **cfg):
    """-> (stats, {(t, lev, box): array}) of a regen with two workers."""
    stats, boxes = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, "HostPacker", _Packer)
        mp.setattr(decompress, "_STREAM_MIN_CHUNK_BYTES", min_chunk_bytes)
        c = common.Config(compressed_dir=archive, device="cpu", **cfg)
        for t, _n, regen, *_ in decompress.iter_decompressed_timesteps(
                c, stats=stats):
            for lev, per in enumerate(regen):
                for b, arr in enumerate(per):
                    boxes[(t, lev, b)] = arr
    return stats, boxes


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32)), k


def _items(n=N_BOX):
    return [batching.WorkItem(t=0, level=0, comp_idx=c, box=b)
            for b in range(n) for c in range(len(COMPS))]


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """Per layout, a one-timestep archive of one bucket: 12 boxes of
    32^3, two components, 24 members."""
    root = tmp_path_factory.mktemp("stream")
    data = _write(str(root), [[((32 * (b % 4), 32 * (b // 4), 0),
                                (32, 32, 32)) for b in range(N_BOX)]],
                  (128, 96, 32))
    out = {}
    for mode in MODES:
        out[mode] = str(root / mode)
        _compress(data, out[mode], mode)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_streamed_regen_is_bit_identical(archives, mode):
    st, boxes = _regen(archives[mode])
    one_st, one_boxes = _regen(archives[mode], OFF)
    _same(boxes, one_boxes)
    assert len(boxes) == N_BOX
    # twelve waits, one a chunk of two rows; none on the one-shot path
    assert st["unpack_wait_seconds"] > 0
    assert "unpack_wait_seconds" not in one_st
    for key in ("unpack_cpu_seconds", "xz_decode_cpu_seconds"):
        assert st[key] > 0 and one_st[key] > 0
    assert st["xz_decoded_bytes"] == one_st["xz_decoded_bytes"] > 0
    assert st["host_to_device_bytes"] == one_st["host_to_device_bytes"]


@pytest.mark.parametrize("mode", MODES)
def test_overlap_counter_and_cores(archives, mode):
    st, _ = _regen(archives[mode])
    busy = st["device_seconds"] + st["assemble_seconds"]
    assert 0 < st["unpack_overlap_seconds"] <= busy
    slack = 1e-3 * 2 * N_BOX    # thread-clock granularity, a member at a time
    assert st["unpack_cpu_seconds"] <= WORKERS * st["unpack_seconds"] + slack
    one_st, _ = _regen(archives[mode], OFF)
    assert one_st["unpack_overlap_seconds"] == 0.0
    assert (one_st["unpack_cpu_seconds"]
            <= WORKERS * one_st["unpack_seconds"] + slack)


@pytest.mark.parametrize("mode", MODES)
def test_largest_first(archives, mode):
    packer = engine.HostPacker(archive_format=mode)
    items = _items()
    if mode == "bundle":
        bs = packer._bundle_set(archives[mode])
        size = {it: bs.locate(it.t, it.level, it.comp_idx, it.box)[2]
                for it in items}
    else:
        size = {it: os.path.getsize(p) for it, p in
                zip(items, packer._paths(archives[mode], items))}
    got = packer.largest_first(archives[mode], items)
    assert sorted(got, key=items.index) == items
    sizes = [size[it] for it in got]
    assert sizes == sorted(sizes, reverse=True) and sizes[0] > sizes[-1]
    # ties keep the given order
    for a, b in zip(got, got[1:]):
        if size[a] == size[b]:
            assert items.index(a) < items.index(b)


def test_largest_first_puts_a_missing_member_last(archives):
    packer = engine.HostPacker()
    items = _items(2) + [batching.WorkItem(t=0, level=0, comp_idx=0,
                                           box=99)]
    assert packer.largest_first(archives["files"], items)[-1] == items[-1]


def _plan(cfg=None, eng=None, packer=None, dims=(64, 64, 64), n=48):
    eng = eng or engine.CodecEngine(device="cpu", layout="auto")
    packer = packer or engine.HostPacker(workers=8)
    cfg = cfg or common.Config(compressed_dir="-", device="cpu")
    return decompress._stream_rows(cfg, eng, packer, dims, n)


def test_stream_rows_engage_on_large_dense_buckets():
    assert _plan() == 8                      # nyx: 48 members of 64^3
    assert _plan(n=16) == 8                  # two chunks exactly
    packer = engine.HostPacker(workers=3)
    assert _plan(packer=packer, n=8) == 4    # 4 MiB: four boxes of 1 MiB


def _packed_engine():
    return engine.CodecEngine(device="cpu", layout="halves")


def _giant_engine(monkeypatch):
    eng = engine.CodecEngine(device="cpu", layout="auto")
    monkeypatch.setattr(eng, "giant_ok", lambda dims: True)
    return eng


@pytest.mark.parametrize("case", ["packed", "packed_nyx", "giant", "sparse",
                                  "preview", "under_two_chunks",
                                  "small_boxes"])
def test_stream_rows_bypass(case, monkeypatch):
    """0 rows, the one-shot path, for packed, giant, sparse and preview
    buckets, and for buckets under two chunks."""
    cfg = {"sparse": common.Config(compressed_dir="-", device="cpu",
                                   transfer="sparse"),
           "preview": common.Config(compressed_dir="-", device="cpu",
                                    preview=1)}.get(case)
    kw = {"packed": dict(eng=_packed_engine(), dims=(8, 8, 8), n=400),
          "packed_nyx": dict(eng=_packed_engine()),
          "giant": dict(eng=_giant_engine(monkeypatch)),
          "under_two_chunks": dict(n=15),
          # 32^3 boxes: a 4 MiB chunk is 32 of them, so 48 are one chunk
          "small_boxes": dict(dims=(32, 32, 32))}.get(case, {})
    assert _plan(cfg=cfg, **kw) == 0


def test_lane_packed_amr_archive_bypasses_streaming(tmp_path, monkeypatch):
    """Four levels of small boxes in four shapes, each with Z dividing
    128: on the halves route every bucket is lane-packed and keeps the
    one-shot path; on the default route the same buckets are unpacked and
    stream; the boxes are the same either way."""
    shapes = [(8, 8, 8), (16, 8, 4), (8, 4, 2), (16, 16, 16)]
    levels = [[((16 * b, 0, 0), d) for b in range(8)] for d in shapes]
    data = _write(str(tmp_path), levels, (128, 16, 16))
    arch = str(tmp_path / "a")
    _compress(data, arch, "bundle", levels=len(shapes))
    monkeypatch.setenv("WAVELET_TPU_LAYOUT", "halves")
    packed_st, packed = _regen(arch)
    _, one = _regen(arch, OFF)
    _same(packed, one)
    assert packed_st["unpack_overlap_seconds"] == 0.0
    assert "unpack_wait_seconds" not in packed_st
    monkeypatch.setenv("WAVELET_TPU_LAYOUT", "auto")
    st, plain = _regen(arch)
    assert st["unpack_wait_seconds"] > 0
    _same(plain, packed)


def _corrupt(archive, mode, item):
    """Flip bytes in the middle of ``item``'s member, keeping its size."""
    if mode == "bundle":
        path, off, size = bundle.BundleSet(archive).locate(
            item.t, item.level, item.comp_idx, item.box)
    else:
        path = engine.HostPacker()._paths(archive, [item])[0]
        off, size = 0, os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(off + size // 2)
        blob = f.read(8)
        f.seek(off + size // 2)
        f.write(bytes(b ^ 0x5A for b in blob))


@pytest.mark.parametrize("mode", MODES)
def test_corrupt_member_in_a_middle_chunk(archives, mode, tmp_path):
    import shutil

    arch = str(tmp_path / mode)
    shutil.copytree(archives[mode], arch)
    order = engine.HostPacker(archive_format=mode).largest_first(
        arch, _items())
    victim = order[len(order) // 2]          # chunk 6 of 12
    _corrupt(arch, mode, victim)
    assert engine.HostPacker(archive_format=mode).largest_first(
        arch, _items()) == order             # the same size, the same place
    with pytest.raises(ValueError) as streamed:
        _regen(arch)
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("wtc-unpack")]
    with pytest.raises(ValueError) as one_shot:
        _regen(arch, OFF)
    assert str(streamed.value) == str(one_shot.value)


def test_stream_under_a_short_switch_interval(archives):
    """32 workers, more than the cores, chunks of three rows and a 1 us
    switch interval: every chunk is handed on once and in order, the rows
    equal the one-shot unpack's, and the counters lose no member."""
    import sys

    dims = (32, 32, 32)
    streamed = engine.HostPacker(workers=32)
    one_shot = engine.HostPacker(workers=32)
    a = batching.empty_batch(_items(), dims)
    b = batching.empty_batch(_items(), dims)
    bounds = [(lo, lo + 3) for lo in range(0, len(a.items), 3)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with streamed.unpack_stream(archives["files"], a, bounds) as stream:
            got = list(stream)
        one_shot.unpack_into(archives["files"], b)
    finally:
        sys.setswitchinterval(old)
    assert got == bounds
    assert np.array_equal(a.data.view(np.uint32), b.data.view(np.uint32))
    assert (streamed.stats["xz_decoded_bytes"]
            == one_shot.stats["xz_decoded_bytes"] > 0)
    assert streamed.stats["unpack_cpu_seconds"] > 0
