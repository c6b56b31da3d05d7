"""The card's share of a streamed decode (``runtime/carddecode``,
``kernels/xzdec_cuda``), on the CPU through the kernel's plain version.

- The plain LZMA2 decoder gives stdlib ``lzma``'s bytes, byte for byte, on
  members that ``archive.xz_compress`` writes: nyx-like payloads at small
  shapes, a header with no pairs, an incompressible payload over 64 KiB
  (stored chunks) and a payload of several LZMA2 chunks.
- Every member the card declines goes to the unchanged host reader, which
  gives its bytes or raises its exact ``ValueError``: concatenated
  streams, stream padding, the delta filter, a flipped CRC64, truncation,
  trailing bytes, a negative run, a position past the box.  A member of
  the encoder's layout whose data or check the card rejects and the host
  reader decodes raises, as does a probe member the card does not decode.
- The host's rate feeds the split from the streamed buckets' own pools,
  in stored bytes.
- The split rule (:func:`carddecode.card_count`) as a pure function.
- A bucket with members forced onto the card regenerates the host-only
  path's boxes bit for bit.
"""

import lzma
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import wavelet_tpu_torch  # noqa: E402
from wavelet_tpu_torch.core import rle  # noqa: E402
from wavelet_tpu_torch.io import archive, plotfile  # noqa: E402
from wavelet_tpu_torch.kernels import xzdec_cuda  # noqa: E402
from wavelet_tpu_torch.pipeline import common, decompress  # noqa: E402
from wavelet_tpu_torch.runtime import carddecode, engine  # noqa: E402

COMPS = ["density", "temp"]
DIMS = (16, 16, 16)
N_BOX = 6           # boxes of 16^3: a bucket of 12 members


def _nyx_like(dims, kept, seed):
    """(runs, values) of a smooth field's kept coefficients."""
    rng = np.random.default_rng(seed)
    m = int(np.prod(dims))
    idx = np.sort(rng.choice(m, int(m * kept), replace=False))
    vals = (np.cumsum(rng.standard_normal(len(idx)))
            * np.exp(rng.standard_normal(len(idx)))).astype(np.float32)
    return rle.rle_encode_pairs(idx), vals


def _payload(case):
    rng = np.random.default_rng(3)
    if case == "nyx_8":
        return archive.serialize_payload((8, 8, 8), *_nyx_like((8, 8, 8),
                                                               0.9, 1))
    if case == "nyx_16":
        return archive.serialize_payload(DIMS, *_nyx_like(DIMS, 0.3, 2))
    if case == "nyx_12x8x4":
        return archive.serialize_payload(
            (12, 8, 4), *_nyx_like((12, 8, 4), 0.6, 3))
    if case == "header_only":
        return archive.serialize_payload(DIMS, np.zeros(0, np.int32),
                                         np.zeros(0, np.float32))
    if case == "stored_over_64k":
        noise = rng.integers(0, 2**32, (10000, 2), dtype=np.uint32)
        return archive.serialize_payload(DIMS, noise[:, 0].view(np.int32),
                                         noise[:, 1].view(np.float32))
    if case == "several_chunks":
        dims = (64, 64, 65)
        m = int(np.prod(dims))
        period = np.cumsum(rng.standard_normal(997)).astype(np.float32)
        return archive.serialize_payload(
            dims, np.zeros(m, np.int32), np.resize(period, m))
    raise KeyError(case)


def _lzma2_chunks(data: bytes) -> list:
    """The control bytes of an LZMA2 stream's chunks."""
    controls, ip = [], 0
    while data[ip]:
        c = data[ip]
        controls.append(c)
        if c < 0x80:
            ip += 3 + (data[ip + 1] << 8 | data[ip + 2]) + 1
        else:
            ip += 6 + (data[ip + 3] << 8 | data[ip + 4]) + (c >= 0xC0)
    return controls


@pytest.mark.parametrize("case", ["nyx_8", "nyx_16", "nyx_12x8x4",
                                  "header_only", "stored_over_64k",
                                  "several_chunks"])
def test_plain_decoder_gives_stdlib_bytes(case):
    payload = _payload(case)
    blob = archive.xz_compress(payload)
    lay = archive.xz_single_block(blob)
    assert lay is not None
    data_off, comp, unc, crc = lay
    data = blob[data_off:data_off + comp]
    status, out, bits = xzdec_cuda.lzma2_decode_plain(data, unc)
    assert status == xzdec_cuda.OK
    assert out == lzma.decompress(blob) == payload
    assert xzdec_cuda.crc64(out) == crc
    assert bits > 0 or case == "stored_over_64k"
    controls = _lzma2_chunks(data)
    if case == "stored_over_64k":
        assert len(payload) > 1 << 16 and controls[0] == 0x01
        assert all(c in (0x01, 0x02) for c in controls)
    if case == "several_chunks":
        assert sum(c >= 0x80 for c in controls) >= 2


def test_plain_decoder_rejects_a_spent_or_short_stream():
    blob = archive.xz_compress(_payload("nyx_16"))
    data_off, comp, unc, _ = archive.xz_single_block(blob)
    data = blob[data_off:data_off + comp]
    assert xzdec_cuda.lzma2_decode_plain(data[:-1], unc)[0] == \
        xzdec_cuda.DATA_ERROR
    assert xzdec_cuda.lzma2_decode_plain(data, unc + 1)[0] == \
        xzdec_cuda.DATA_ERROR
    assert xzdec_cuda.lzma2_decode_plain(data + b"\x00", unc)[0] == \
        xzdec_cuda.DATA_ERROR


def test_container_layout_and_sizes():
    payload = _payload("nyx_16")
    blob = archive.xz_compress(payload)
    lay = archive.xz_single_block(blob)
    assert lay[2] == len(payload)
    assert lay[3] == xzdec_cuda.crc64(payload)
    for other in (blob + b"\x00" * 4, blob[:-1], blob + b"x",
                  blob + archive.xz_compress(payload),
                  archive.xz_compress(payload, archive.pack_preset(6, 8))):
        assert archive.xz_single_block(other) is None


# ---- declines: the host reader's bytes, or its exact ValueError --------

def _write_archive(root, mode="files", steps=1):
    """An archive of ``steps`` timesteps of N_BOX boxes of 16^3, two
    components: one streamed bucket of 12 members a timestep."""
    rng = np.random.default_rng(7)
    data = os.path.join(root, f"data{steps}")
    names = [f"plt000{10 * (s + 1)}" for s in range(steps)]
    for name in names:
        boxes = [[rng.standard_normal((len(COMPS),) + DIMS)
                  .astype(np.float32).cumsum(axis=1) for _ in range(N_BOX)]]
        plotfile.write_plotfile(
            os.path.join(data, name), boxes,
            [[(16 * i, 0, 0) for i in range(N_BOX)]], [[DIMS] * N_BOX],
            COMPS, 0.5, [0.0, 0.0, 0.0], [1.0, 1.0, 1.0], (2, 2, 2),
            (16 * N_BOX, 16, 16), [10])
    out = os.path.join(root, f"arch_{mode}{steps}")
    wavelet_tpu_torch.compress(
        data, out, min_time=names[0], max_time=names[-1],
        components=COMPS, min_level=0, max_level=0, keep=0.999,
        device="cpu", archive=mode)
    return out


class _Packer(engine.HostPacker):
    def __init__(self, *a, **k):
        k["workers"] = 2
        super().__init__(*a, **k)


def _regen(arch, card_members):
    """-> (stats, {(t, lev, box): array}, the ValueError's text or None)
    with ``card_members(n)`` members of each streamed bucket on the card
    (the plain version, on the CPU)."""
    stats, boxes = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, "HostPacker", _Packer)
        mp.setattr(decompress, "_STREAM_MIN_CHUNK_BYTES", 0)
        mp.setattr(decompress, "_card_members",
                   lambda cfg, eng, packer, dims, items, *a:
                   (card_members(len(items)), 0.0))
        cfg = common.Config(compressed_dir=arch, device="cpu")
        try:
            for t, _n, regen, *_ in decompress.iter_decompressed_timesteps(
                    cfg, stats=stats):
                for lev, per in enumerate(regen):
                    for b, arr in enumerate(per):
                        boxes[(t, lev, b)] = arr
        except ValueError as e:
            return stats, boxes, str(e)
    return stats, boxes, None


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """One timestep in files mode (the declines); two timesteps in both
    layouts, so that the second's card members launch one timestep
    ahead."""
    root = str(tmp_path_factory.mktemp("card"))
    return {"files1": _write_archive(root, "files"),
            **{mode: _write_archive(root, mode, 2)
               for mode in ("files", "bundle")}}


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k].view(np.int32), b[k].view(np.int32))


@pytest.mark.parametrize("mode", ["files", "bundle"])
@pytest.mark.parametrize("share", ["tail", "all"])
def test_forced_card_members_regenerate_host_boxes(archives, mode, share):
    arch = archives[mode]
    _, want, err = _regen(arch, lambda n: 0)
    assert err is None
    k = (lambda n: 5) if share == "tail" else (lambda n: n)
    stats, got, err = _regen(arch, k)
    assert err is None
    _same(want, got)
    n_card = 2 * (5 if share == "tail" else 2 * N_BOX)   # two timesteps
    assert stats["card_decoded_members"] == n_card
    assert stats["card_declined_members"] == 0
    assert stats["card_decoded_bytes"] > 0
    assert stats["card_decode_seconds"] > 0
    # the host counters count the host's members alone
    files = archives["files"]
    total = 0
    for f in os.listdir(files):
        if f.endswith(".xz"):
            with open(os.path.join(files, f), "rb") as fh:
                total += len(archive.xz_decompress(fh.read()))
    assert stats["xz_decoded_bytes"] + stats["card_decoded_bytes"] == total


def _variant(kind, payload, blob):
    if kind == "concatenated":
        h = len(payload) // 2
        return archive.xz_compress(payload[:h]) + archive.xz_compress(
            payload[h:])
    if kind == "stream_padding":
        return blob + b"\x00" * 4
    if kind == "xzdelta":
        return archive.xz_compress(payload, archive.pack_preset(6, 8))
    if kind == "flipped_crc64":
        lay = archive.xz_single_block(blob)
        bad = bytearray(blob)
        bad[lay[0] + lay[1] + (-lay[1] % 4)] ^= 0x01
        return bytes(bad)
    if kind == "truncated":
        return blob[:-7]
    if kind == "trailing_bytes":
        return blob + b"WTCZ"
    shape, total, runs, vals = archive.deserialize_payload(payload)
    runs = runs.copy()
    if kind == "negative_run":
        runs[len(runs) // 2] = -3
    elif kind == "past_the_box":
        runs[-1] = total
    return archive.xz_compress(archive.serialize_payload(shape, runs, vals))


@pytest.mark.parametrize("kind", ["concatenated", "stream_padding",
                                  "xzdelta", "flipped_crc64", "truncated",
                                  "trailing_bytes", "negative_run",
                                  "past_the_box"])
def test_declined_members_go_to_the_host_reader(archives, tmp_path, kind):
    src = archives["files1"]
    arch = str(tmp_path / "arch")
    os.makedirs(arch)
    names = sorted(os.listdir(src))
    for f in names:
        with open(os.path.join(src, f), "rb") as a, \
                open(os.path.join(arch, f), "wb") as b:
            b.write(a.read())
    member = os.path.join(arch, archive.payload_filename(0, 0, 0, 2))
    with open(member, "rb") as f:
        blob = f.read()
    with open(member, "wb") as f:
        f.write(_variant(kind, lzma.decompress(blob), blob))
    _, want, want_err = _regen(arch, lambda n: 0)
    stats, got, err = _regen(arch, lambda n: n)
    assert err == want_err
    if kind in ("flipped_crc64", "truncated", "trailing_bytes"):
        assert err is not None
        return
    assert err is None
    _same(want, got)
    assert stats["card_declined_members"] == 1
    assert stats["card_decoded_members"] == 2 * N_BOX - 1


def _fail_on_card(mp, status):
    """The plain version rejecting every member's data or check."""
    if status == xzdec_cuda.DATA_ERROR:
        mp.setattr(xzdec_cuda, "lzma2_decode_plain",
                   lambda data, unc: (xzdec_cuda.DATA_ERROR, b"", 0))
    else:
        mp.setattr(xzdec_cuda, "crc64", lambda data: -1)


@pytest.mark.parametrize("status", [xzdec_cuda.DATA_ERROR,
                                    xzdec_cuda.CHECK_ERROR])
def test_a_valid_member_the_card_rejects_raises(archives, status):
    with pytest.MonkeyPatch.context() as mp:
        _fail_on_card(mp, status)
        with pytest.raises(RuntimeError,
                           match=rf"xzdec rejected .*status {status}\)"):
            _regen(archives["files1"], lambda n: 3)


@pytest.mark.parametrize("fail", [None, xzdec_cuda.DATA_ERROR,
                                  xzdec_cuda.CHECK_ERROR])
def test_the_probe_takes_the_card_rate_or_raises(fail):
    rates = carddecode.CardRates()
    with pytest.MonkeyPatch.context() as mp:
        if fail is not None:
            _fail_on_card(mp, fail)
            with pytest.raises(RuntimeError, match=f"status {fail} "):
                rates._probe(torch.device("cpu"))
            assert rates.card_bps(torch.device("cpu")) is None
            return
        rates._probe(torch.device("cpu"))
    # stored bytes a second of the probe member's one block
    assert 0 < rates.card[0] < carddecode._PROBE_PAIRS * 8
    assert rates.card_bps(torch.device("cpu")) > 0


def test_streamed_buckets_feed_the_host_rate_in_stored_bytes(archives):
    arch = archives["files"]
    stored = sum(os.path.getsize(os.path.join(arch, f))
                 for f in os.listdir(arch) if f.endswith(".xz"))
    rates = carddecode.CardRates()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(carddecode, "RATES", rates)
        _regen(arch, lambda n: 0)
        assert rates.host[0] == stored
        assert rates.host[1] > 0
        _regen(arch, lambda n: 5)
    # the card's five smallest a bucket are not the host's
    assert stored < rates.host[0] < 2 * stored


# ---- the split rule ------------------------------------------------------

def test_card_count_no_card_members_without_both_rates_or_a_win():
    sizes = [8.0] * 10 + [1.0] * 10
    kw = dict(workers=8, sms=132)
    assert carddecode.card_count(sizes, host_bps=None, card_bps=1.0,
                                 **kw) == 0
    assert carddecode.card_count(sizes, host_bps=1.0, card_bps=None,
                                 **kw) == 0
    assert carddecode.card_count([], host_bps=1.0, card_bps=1.0, **kw) == 0
    # a card a thousand times slower than a core never finishes first
    assert carddecode.card_count(sizes, host_bps=1.0, card_bps=1e-3,
                                 **kw) == 0
    # a launch that costs more than the whole host decode
    assert carddecode.card_count(sizes, host_bps=1.0, card_bps=1.0,
                                 launch_s=100.0, **kw) == 0


def test_card_count_takes_the_smallest_and_balances():
    sizes = [10.0, 9.0, 8.0, 7.0, 6.0, 5.0, 4.0, 3.0, 2.0, 1.0]
    # one worker at 1 byte/s, a card stream as fast: the card takes the
    # tail up to where the two finish together
    k = carddecode.card_count(sizes, host_bps=1.0, workers=1, card_bps=1.0,
                              sms=132)
    host, card = sizes[:len(sizes) - k], sizes[len(sizes) - k:]
    assert 0 < k < len(sizes)
    assert min(host) >= max(card)
    assert k == 9      # host 10 s beside the card's largest, 9 s
    # the host's largest member bounds its finish: moving a small member
    # to the card finishes no sooner, so the card takes none
    assert carddecode.card_count([100.0, 1.0], host_bps=1.0, workers=8,
                                 card_bps=1.0, sms=132) == 0


def test_card_count_models_waves_of_blocks():
    sizes = [1.0] * 300
    one_wave = carddecode.card_count(sizes, host_bps=1.0, workers=1,
                                     card_bps=1.0, sms=1000)
    assert one_wave == 299
    # 132 blocks a wave: 297 members take three waves (3 s), as long as
    # the host's last three
    assert carddecode.card_count(sizes, host_bps=1.0, workers=1,
                                 card_bps=1.0, sms=132) == 297


@pytest.mark.parametrize("seed", range(6))
def test_card_count_is_a_split_no_worse_than_the_host(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 200))
    sizes = sorted(rng.exponential(1e6, n), reverse=True)
    host_bps, card_bps = rng.uniform(1e6, 4e7), rng.uniform(1e5, 1e7)
    workers, sms = int(rng.integers(1, 33)), int(rng.integers(1, 200))
    k = carddecode.card_count(sizes, host_bps=host_bps, workers=workers,
                              card_bps=card_bps, sms=sms)
    assert 0 <= k <= n

    def finish(k):
        host = sizes[:n - k]
        card = sizes[n - k:]
        h = (max(sum(host) / (workers * host_bps), host[0] / host_bps)
             if host else 0.0)
        c = sum(card[w] for w in range(0, k, sms)) / card_bps
        return max(h, c)
    assert finish(k) <= finish(0)
    assert all(finish(k) <= finish(j) for j in range(n + 1))
