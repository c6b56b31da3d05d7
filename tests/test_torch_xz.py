"""The port's Python xz writer against the system liblzma, byte for byte.

``wavelet_tpu_torch.io.archive.xz_compress`` must return what liblzma's
buffer encoder returns for the same payload and preset word, as the
native codec (native/wtc_codec.cpp:274-293) and the reference's
compressor.cpp call it: ``lzma_easy_buffer_encode(p, LZMA_CHECK_CRC64)``,
or with a delta distance ``lzma_stream_buffer_encode`` over the delta +
LZMA2 chain.  The reference here is that very library through ctypes, so
it shares no code with the writer under test.  The cases reach both of
the buffer encoder's block forms:

- incompressible payloads above 64 KiB, where liblzma rewrites the block
  as stored LZMA2 chunks under LZMA2 alone at ``LZMA_DICT_SIZE_MIN``;
- compressible payloads where the width of the block header's reserved
  compressed-size varint changes (``lzma2_bound(n)`` crossing 2^14 and
  2^21), which sets the header's size under the delta chain.

Both of the writer's paths are held to it: liblzma's buffer encoder
called through ctypes (without the delta filter, where liblzma loads) and
stdlib ``lzma`` reframed.  Every case also decodes back to its payload.
Where the JAX package's native codec loads, a box's member written by the
port's sparse and dense paths equals the one that codec writes.  Skipped
where liblzma is not found.
"""

import ctypes
import ctypes.util
import functools
import os

import numpy as np
import pytest

from wavelet_tpu_torch.io import archive
from wavelet_tpu_torch.runtime import batching, engine

_LIB = ctypes.util.find_library("lzma")
pytestmark = pytest.mark.skipif(_LIB is None,
                                reason="no system liblzma to compare with")

LZMA_CHECK_CRC64 = 4
LZMA_FILTER_DELTA = 0x03
LZMA_FILTER_LZMA2 = 0x21
LZMA_VLI_UNKNOWN = 2 ** 64 - 1


class _Filter(ctypes.Structure):
    _fields_ = [("id", ctypes.c_uint64), ("options", ctypes.c_void_p)]


class _DeltaOptions(ctypes.Structure):
    # lzma/delta.h: type, dist, four reserved ints, two reserved pointers
    _fields_ = ([("type", ctypes.c_int), ("dist", ctypes.c_uint32)]
                + [(f"reserved_int{i}", ctypes.c_uint32) for i in range(4)]
                + [("reserved_ptr1", ctypes.c_void_p),
                   ("reserved_ptr2", ctypes.c_void_p)])


@functools.cache
def _liblzma():
    lib = ctypes.CDLL(_LIB)
    out = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t), ctypes.c_size_t]
    lib.lzma_easy_buffer_encode.argtypes = [
        ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_size_t, *out]
    lib.lzma_easy_buffer_encode.restype = ctypes.c_int
    lib.lzma_stream_buffer_encode.argtypes = [
        ctypes.POINTER(_Filter), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_size_t, *out]
    lib.lzma_stream_buffer_encode.restype = ctypes.c_int
    lib.lzma_lzma_preset.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.lzma_lzma_preset.restype = ctypes.c_ubyte          # lzma_bool
    return lib


def liblzma_encode(payload: bytes, word: int) -> bytes:
    """The native codec's encode of ``payload`` under the
    :func:`archive.pack_preset` word, with its output capacity."""
    lib = _liblzma()
    preset, delta = word & 0xFF, (word >> 8) & 0xFF
    n = len(payload)
    cap = n + n // 3 + 256
    out = ctypes.create_string_buffer(cap)
    pos = ctypes.c_size_t(0)
    if delta:
        dopt = _DeltaOptions(type=0, dist=delta)   # LZMA_DELTA_TYPE_BYTE
        lopt = ctypes.create_string_buffer(512)    # >= lzma_options_lzma
        assert lib.lzma_lzma_preset(lopt, preset) == 0
        chain = (_Filter * 3)(
            _Filter(LZMA_FILTER_DELTA, ctypes.addressof(dopt)),
            _Filter(LZMA_FILTER_LZMA2, ctypes.addressof(lopt)),
            _Filter(LZMA_VLI_UNKNOWN, None))
        ret = lib.lzma_stream_buffer_encode(
            chain, LZMA_CHECK_CRC64, None, payload, n, out, ctypes.byref(pos),
            cap)
    else:
        ret = lib.lzma_easy_buffer_encode(
            preset, LZMA_CHECK_CRC64, None, payload, n, out,
            ctypes.byref(pos), cap)
    assert ret == 0, f"liblzma returned {ret}"
    return out.raw[:pos.value]


def _ramp(n: int) -> bytes:
    return (np.arange(n) % 251).astype(np.uint8).tobytes()


def _pairs(n_pairs: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    p = np.empty(n_pairs, np.dtype([("run", "<i4"), ("val", "<f4")]))
    p["run"] = rng.integers(0, 50, n_pairs)
    p["val"] = rng.standard_normal(n_pairs)
    return p.tobytes()


# name -> payload maker; random sizes straddle the 65,536-byte LZMA2 chunk
PAYLOADS = {
    **{f"random-{n}": (lambda n=n: np.random.default_rng(n).bytes(n))
       for n in (100, 4096, 65000, 65535, 65536, 65537, 131072, 131073,
                 1 << 20)},
    "zeros-30000-then-random-100000": lambda: (
        bytes(30000) + np.random.default_rng(7).bytes(100000)),
    "pairs-20000": lambda: _pairs(20000, 8),
    **{f"ramp-{n}": (lambda n=n: _ramp(n))
       for n in (16250, 16288, 16379, 16380, 16383, 16384, 16400,
                 2096900, 2097055, 2097151, 2097152, 2097200)},
    "empty": lambda: b"",
}
# the pack_preset words: presets 0, 6 and 9, and xzdelta=8 at preset 6
WORDS = {"p0": 0, "p6": 6, "p9": 9, "p6-delta8": archive.pack_preset(6, 8)}


@pytest.mark.parametrize("word", list(WORDS), ids=list(WORDS))
@pytest.mark.parametrize("name", list(PAYLOADS), ids=list(PAYLOADS))
def test_xz_compress_is_liblzma_s_bytes(name, word):
    payload = PAYLOADS[name]()
    blob = archive.xz_compress(payload, WORDS[word])
    want = liblzma_encode(payload, WORDS[word])
    assert len(blob) == len(want)
    assert blob == want
    assert archive.xz_decompress(blob) == payload


@pytest.mark.parametrize("word", list(WORDS), ids=list(WORDS))
@pytest.mark.parametrize("name", list(PAYLOADS), ids=list(PAYLOADS))
def test_stdlib_writer_is_liblzma_s_bytes(name, word, monkeypatch):
    """The stdlib ``lzma`` writer, which ``xz_compress`` takes under the
    delta filter and where liblzma does not load, returns the same
    bytes."""
    monkeypatch.setattr(archive, "_easy_buffer_encode", lambda *a: None)
    payload = PAYLOADS[name]()
    blob = archive.xz_compress(payload, WORDS[word])
    assert blob == liblzma_encode(payload, WORDS[word])
    assert archive.xz_decompress(blob) == payload


@pytest.mark.parametrize("n", [65000, 65536, 1 << 20])
def test_incompressible_payloads_take_the_stored_block(n):
    """liblzma's stored form: LZMA2 alone with property byte 0x00 in the
    block header, and the payload itself in chunks of at most 64 KiB."""
    payload = np.random.default_rng(n).bytes(n)
    for word in WORDS.values():
        blob = archive.xz_compress(payload, word)
        hdr = blob[12:12 + (blob[12] + 1) * 4]
        assert hdr[1] == 0xC0                  # one filter, both sizes
        assert archive._STORED_FILTER in hdr
        data = blob[12 + len(hdr):]
        assert data[0] == 0x01 and data[3:3 + 100] == payload[:100]
        assert len(blob) == len(liblzma_encode(payload, word))


def _box(kept: int, seed: int):
    """One 64^3 box of zeros and ``kept`` N(0, 10) values at random
    positions: its RLE payload is 20 + 8 * kept bytes."""
    rng = np.random.default_rng(seed)
    flat = np.zeros(64 ** 3, np.float32)
    pos = rng.choice(flat.size, kept, replace=False)
    flat[pos] = (rng.standard_normal(kept) * 10).astype(np.float32)
    flat[pos[flat[pos] == 0]] = 1.0
    return flat


@pytest.mark.parametrize("kept,delta", [(2040, 8), (2040, 0), (40000, 0)],
                         ids=["16340B-delta8", "16340B", "320020B"])
def test_sparse_member_equals_the_native_dense_member(tmp_path, kept, delta):
    """The same box through ``wavelet_tpu.native.pack_strided`` (the JAX
    package's C++ codec) and the port's ``HostPacker.pack`` and
    ``HostPacker.pack_sparse``: one member's bytes, and liblzma's.  A
    16,340-byte payload under ``xzdelta=8`` is where the header reserve of
    the delta chain takes the compressed-size varint of ``lzma2_bound(n)``
    (2 bytes) and not of a larger bound (3 bytes), which made the header 4
    bytes longer than the native one."""
    from wavelet_tpu import native as jnative

    if not jnative.available():
        pytest.skip("the JAX package's native codec does not build here")
    flat = _box(kept, seed=kept + delta)
    item = batching.WorkItem(0, 0, 0, 0)
    dims = (64, 64, 64)
    t32 = np.zeros(1, np.float32)
    dense = batching.ShapeBatch(shape=dims, data=flat.reshape(1, *dims),
                                items=[item], n_valid=1)
    idx = np.flatnonzero(flat).astype(np.int32)
    sparse = engine.SparseCoeffs(
        shape=dims, items=[item], counts=np.array([kept], np.int32),
        idxs=idx[None], vals=flat[idx][None], cap=kept)
    m = flat.size
    word = archive.pack_preset(6, delta)
    (tmp_path / "native").mkdir()
    jnative.pack_strided(flat[None], t32, dims,
                         [str(tmp_path / "native" / "m.xz")], 1, m, m,
                         np.zeros(1, np.int64), 1, preset=word)
    blobs = {"native": (tmp_path / "native" / "m.xz").read_bytes()}
    for kind in ("dense", "sparse"):
        out = tmp_path / kind
        out.mkdir()
        packer = engine.HostPacker(xz_delta=delta)
        if kind == "dense":
            packer.pack(str(out), dense, t32)
        else:
            packer.pack_sparse(str(out), sparse, t32)
        (name,) = os.listdir(out)
        blobs[kind] = (out / name).read_bytes()
    payload = archive.xz_decompress(blobs["native"])
    assert len(payload) == 20 + 8 * kept
    assert blobs["sparse"] == blobs["dense"] == blobs["native"]
    assert blobs["native"] == liblzma_encode(payload, word)
