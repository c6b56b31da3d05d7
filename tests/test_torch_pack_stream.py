"""The pack stream (``runtime/packstream.PackStream``, fed by
``pipeline/compress._pack_overlapped``).

Every batch's members go to one queue per packer, worked largest payload
first with no barrier between batches or timesteps.  The archive must be
byte for byte the one a one-worker, one-batch-at-a-time pack writes, in
both layouts and at any worker count; the next timestep's read must run
while the last one's members pack, and ``pack_overlap_seconds`` must say
so; a member that fails must reach the caller and leave no later bundle
closed, and a ``resume=1`` rerun must then complete the archive as a
clean run writes it.  The streamed archive is also the one the JAX
package writes with its native C++ codec.
"""

import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import wavelet_tpu_torch  # noqa: E402
from wavelet_tpu_torch.io import archive, bundle, plotfile  # noqa: E402
from wavelet_tpu_torch.runtime import batching, engine  # noqa: E402

COMPS = ["density", "temp"]
MODES = ["files", "bundle"]
TIMES = ["plt00010", "plt00020", "plt00030"]
# three box shapes on level 0, two on level 1
L0 = [((0, 0, 0), (8, 8, 8)), ((8, 0, 0), (8, 8, 8)),
      ((0, 8, 0), (16, 8, 8))]
L1 = [((0, 0, 0), (7, 5, 3)), ((8, 0, 0), (12, 12, 12)),
      ((0, 16, 0), (7, 5, 3))]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Three timesteps of two levels, five boxes of three shapes and one
    of two more, two components: 36 members a timestep in 6 batches."""
    root = str(tmp_path_factory.mktemp("packstream") / "data")
    rng = np.random.default_rng(11)
    for t, name in enumerate(TIMES):
        boxes = [[rng.standard_normal((len(COMPS),) + d).astype(np.float32)
                  .cumsum(axis=1) for _, d in lev] for lev in (L0, L1)]
        plotfile.write_plotfile(
            os.path.join(root, name), boxes,
            [[loc for loc, _ in lev] for lev in (L0, L1)],
            [[d for _, d in lev] for lev in (L0, L1)],
            COMPS, 0.5 + t, [0.0, 0.0, 0.0], [1.0, 0.5, 0.5], (2, 2, 2),
            (16, 16, 8), [10 * (t + 1), 20 * (t + 1)])
    return root


def _workers(n):
    class Packer(engine.HostPacker):
        def __init__(self, *a, **k):
            k["workers"] = n
            super().__init__(*a, **k)
    return Packer


class _OneAtATime(engine.HostPacker):
    """The reference: one worker, each batch packed to its end before the
    next is handed over."""

    def __init__(self, *a, **k):
        k["workers"] = 1
        super().__init__(*a, **k)

    def submit(self, *a, **k):
        fut = super().submit(*a, **k)
        fut.result()
        return fut


def _compress(data, out, mode, packer_cls, monkeypatch, times=TIMES,
              **opts):
    with monkeypatch.context() as mp:
        mp.setattr(engine, "HostPacker", packer_cls)
        return wavelet_tpu_torch.compress(
            data, out, min_time=times[0], max_time=times[-1],
            components=COMPS, min_level=0, max_level=1, keep=0.999,
            device="cpu", archive=mode, **opts)


def _tree(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def reference(data, tmp_path_factory):
    """Per layout, the one-worker, one-batch-at-a-time archive."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for mode in MODES:
            d = str(tmp_path_factory.mktemp("ref") / mode)
            _compress(data, d, mode, _OneAtATime, mp)
            out[mode] = _tree(d)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("workers", [1, 3, 8])
@pytest.mark.parametrize("mode", MODES)
def test_stream_bytes_equal_one_batch_at_a_time(data, reference, mode,
                                                workers, tmp_path,
                                                monkeypatch):
    out = str(tmp_path / "a")
    st = _compress(data, out, mode, _workers(workers), monkeypatch)
    tree = _tree(out)
    assert tree == reference[mode]
    n_members = len(TIMES) * (len(L0) + len(L1)) * len(COMPS)
    assert st["files"] == n_members
    if mode == "bundle":
        assert len(bundle.list_bundles(out)) == len(TIMES)
        assert st["output_bytes"] == sum(
            len(b) for k, b in tree.items() if k.endswith(".wtb"))
    # the union of the batches' intervals fits the call, and the pool
    assert 0 < st["pack_seconds"] <= st["compress_seconds"]
    slack = 1e-3 * 2 * n_members   # thread-clock granularity, two stages
    assert st["pack_cpu_seconds"] <= workers * st["pack_seconds"] + slack


def _slow_codec(monkeypatch, seconds):
    """xz that takes at least ``seconds`` a member."""
    real = archive.encode_blob

    def slow(payload, *a, **k):
        time.sleep(seconds)
        return real(payload, *a, **k)
    monkeypatch.setattr(archive, "encode_blob", slow)


def test_next_timestep_reads_while_the_last_one_packs(data, tmp_path,
                                                      monkeypatch):
    reads, ends = [], []
    real_read, real_write = plotfile.read_level, engine._atomic_write

    def read_level(path, *a, **k):
        reads.append((os.path.basename(path), time.perf_counter()))
        return real_read(path, *a, **k)

    def atomic_write(path, blob):
        real_write(path, blob)
        t = int(os.path.basename(path).split("-")[2])
        ends.append((t, time.perf_counter()))

    monkeypatch.setattr(plotfile, "read_level", read_level)
    monkeypatch.setattr(engine, "_atomic_write", atomic_write)
    _slow_codec(monkeypatch, 0.02)
    st = _compress(data, str(tmp_path / "a"), "files", _workers(2),
                   monkeypatch, times=TIMES[:2])
    t1_read = min(s for name, s in reads if name == TIMES[1])
    t0_last = max(e for t, e in ends if t == 0)
    assert t1_read < t0_last
    assert 0 < st["pack_overlap_seconds"] <= (st["read_seconds"]
                                              + st["device_seconds"])


def test_a_single_batch_shows_no_overlap(data, tmp_path, monkeypatch):
    """One timestep of one box shape on one worker: nothing was packing
    while the read and the step ran."""
    root = str(tmp_path / "one")
    plotfile.write_plotfile(
        os.path.join(root, "plt00010"),
        [[np.ones((len(COMPS), 8, 8, 8), np.float32).cumsum(axis=1)]],
        [[(0, 0, 0)]], [[(8, 8, 8)]], COMPS, 0.5, [0.0, 0.0, 0.0],
        [1.0, 1.0, 1.0], (2, 2, 2), (8, 8, 8), [10])
    with monkeypatch.context() as mp:
        mp.setattr(engine, "HostPacker", _workers(1))
        st = wavelet_tpu_torch.compress(
            root, str(tmp_path / "a"), min_time="plt00010",
            max_time="plt00010", components=COMPS, min_level=0,
            max_level=0, keep=0.999, device="cpu")
    assert st["files"] == len(COMPS)
    assert st["pack_overlap_seconds"] == 0.0
    assert st["pack_seconds"] > 0


def _coeff_batch(n, seed, lo, hi):
    """A coefficient batch of ``n`` 8^3 items whose thresholds keep from
    ``lo`` to ``hi``, so their payloads differ in length."""
    rng = np.random.default_rng(seed)
    items = [batching.WorkItem(t=seed, level=0, comp_idx=0, box=i)
             for i in range(n)]
    data = rng.standard_normal((n, 8, 8, 8)).astype(np.float32)
    cb, _ = engine.CodecEngine(device="cpu").compress_shapebatch(
        batching.ShapeBatch(shape=(8, 8, 8), data=data, items=items,
                            n_valid=n), 0.9)
    keep = rng.permutation(np.linspace(lo, hi, n))
    t32 = np.array([np.quantile(np.abs(cb.item_view(i)), 1 - k)
                    for i, k in enumerate(keep)], np.float32)
    return cb, t32


@pytest.mark.parametrize("mode", MODES)
def test_largest_payload_first_across_batches(tmp_path, monkeypatch, mode):
    """One worker: batch A's members queue together and the largest goes
    first; batch B arrives while it packs, and the rest of A and all of B
    then go largest first, whichever batch they belong to.  The bytes are
    those of the batches packed one after the other."""
    order = []
    gate = threading.Event()
    real = archive.encode_blob

    def gated(payload, *a, **k):
        order.append(len(payload))
        if len(order) == 1:
            assert gate.wait(30)
        return real(payload, *a, **k)

    a, ta = _coeff_batch(6, 0, 0.05, 0.65)
    b, tb = _coeff_batch(6, 1, 0.1, 0.95)
    monkeypatch.setattr(archive, "encode_blob", gated)
    for d in ("s", "one"):
        (tmp_path / d).mkdir()
    packer = engine.HostPacker(workers=1, archive_format=mode)
    fa = packer.submit(str(tmp_path / "s"), a, ta)
    deadline = time.monotonic() + 30
    while not order and time.monotonic() < deadline:
        time.sleep(0.001)
    fb = packer.submit(str(tmp_path / "s"), b, tb)
    gate.set()
    assert fa.result() > 0 and fb.result() > 0
    packer.close_bundles()

    # the batches one after the other, each member's payload length logged
    lengths = []

    def logged(payload, *a, **k):
        lengths[-1].append(len(payload))
        return real(payload, *a, **k)
    monkeypatch.setattr(archive, "encode_blob", logged)
    one = engine.HostPacker(workers=1, archive_format=mode)
    for cb, t32 in ((a, ta), (b, tb)):
        lengths.append([])
        one.pack(str(tmp_path / "one"), cb, t32)
    one.close_bundles()
    len_a, len_b = lengths
    assert len(set(len_a + len_b)) > 6
    assert order[0] == max(len_a)
    assert sorted(order) == sorted(len_a + len_b)
    assert order[1:] == sorted(order[1:], reverse=True)
    assert order[1] > min(len_a)     # a member of B before one of A
    assert _tree(str(tmp_path / "s")) == _tree(str(tmp_path / "one"))


@pytest.mark.parametrize("mode", MODES)
def test_native_backend_keeps_its_bytes(data, mode, tmp_path, monkeypatch):
    """The port's streamed archive, on its one codec, is byte for byte the
    one ``wavelet_tpu`` writes with its native C++ codec."""
    from wavelet_tpu import api as japi
    from wavelet_tpu import native as jnative

    if not jnative.available():
        pytest.skip("the JAX package's native codec does not build here")
    out, jout = str(tmp_path / "a"), str(tmp_path / "jax")
    st = _compress(data, out, mode, engine.HostPacker, monkeypatch)
    jst = japi.compress(data, jout, min_time=TIMES[0], max_time=TIMES[-1],
                        components=COMPS, min_level=0, max_level=1,
                        keep=0.999, archive=mode)
    assert jst["files"] == st["files"]
    assert _tree(out) == _tree(jout)
    assert st["pack_cpu_seconds"] > 0 and st["xz_in_bytes"] > 0


def _planted(monkeypatch, t_bad):
    """Member (t_bad, level 0, box 0, first component) raises in its
    pack."""
    real = engine.HostPacker._member

    def member(self, out_dir, items, shape, pairs):
        enc = real(self, out_dir, items, shape, pairs)

        def encode(k):
            it = items[k]
            if (it.t, it.level, it.box, it.comp_idx) == (t_bad, 0, 0, 0):
                raise RuntimeError("planted member failure")
            return enc(k)
        return encode
    monkeypatch.setattr(engine.HostPacker, "_member", member)


@pytest.mark.parametrize("mode", MODES)
def test_a_failed_member_reaches_the_caller_and_resume_completes(
        data, reference, mode, tmp_path, monkeypatch):
    out = str(tmp_path / "a")
    with monkeypatch.context() as mp:
        _planted(mp, 1)
        _slow_codec(mp, 0.005)
        with pytest.raises(RuntimeError, match="planted member failure"):
            _compress(data, out, mode, _workers(3), mp)
    if mode == "bundle":
        # timestep 0's bundle closed before the failure; 1 and 2 are not
        # closed (an unclosed bundle is a .tmp that no reader lists)
        assert [n.split("-")[1] for n in bundle.list_bundles(out)] == \
            ["t00000"]
    else:
        bad = archive.payload_filename(1, 0, 0, 0)
        assert not os.path.exists(os.path.join(out, bad))
    _compress(data, out, mode, _workers(3), monkeypatch, resume=1)
    tree = {k: v for k, v in _tree(out).items() if not k.endswith(".tmp")}
    assert tree == reference[mode]
