"""Compressed-archive byte formats: sidecar files and per-box ``.xz`` payloads.

The port's own copy of ``wavelet_tpu/io/archive.py``, so that the port
imports nothing of ``wavelet_tpu``.  It differs in one function:
:func:`xz_compress` writes liblzma's buffer-encoder bytes for every
payload, where ``wavelet_tpu``'s Python writer departs from them (and so
from its own native writer and the C++ tool) on incompressible payloads
above 64 KiB and on 16,288-16,379-byte payloads under the delta filter;
and without the delta filter it calls that encoder itself, through
ctypes, where the system liblzma loads.  It also reads that encoder's
layout (:func:`xz_single_block`) for the members the card decodes
(``runtime/carddecode``).

Byte-compatible with the reference so either tool can read the other's
archives (the compatibility contract of SURVEY.md §4.2):

- ``runinfo.raw``       (readandwrite.cpp:362-395)
- ``locations.raw`` / ``dimensions.raw``  (:226-269 — ints stored as float32!)
- ``boxcounts.raw``     (:273-317 — counts stored as float32)
- ``amrexinfo.raw``     (:321-358 — incl. 16-byte x86 ``long double`` times)
- ``compressed-wavelet-{t}-{lev}-{compidx}-{box}.xz``  (compressor.cpp:250-291)
  where *compidx is the plotfile-Header component index*, not 0..C-1.

Payload inside each ``.xz`` (serialize_compressed_wavelet,
compressor.cpp:55-80):

    int32 x3   box shape (x, y, z)
    int32      total coefficient count (= x*y*z)
    int32      number of RLE pairs
    repeat     { int32 zeros_before, float32 value }

LZMA parameters and container bytes match
``lzma_easy_buffer_encode(6, LZMA_CHECK_CRC64)``.

Note: the reference computes a ``need32`` flag but never serializes it
(box-structs.h:69, SURVEY.md §4.2 quirk); the format has no such field and we
don't reproduce the dead flag.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import lzma
import os
import struct
import zlib

import numpy as np

__all__ = [
    "RunInfo", "AMReXInfo",
    "serialize_payload", "deserialize_payload",
    "serialize_payload_q16", "deserialize_payload_q16",
    "xz_compress", "xz_decompress", "xz_single_block", "encode_blob",
    "decode_blob", "payload_filename",
    "write_runinfo", "read_runinfo",
    "write_locdim", "read_locdim",
    "write_boxcounts", "read_boxcounts",
    "write_amrexinfo", "read_amrexinfo",
    "META_NAME", "write_meta", "read_meta",
]

def _atomic_write_bytes(path: str, blob: bytes) -> None:
    """Write via a per-process temp name + rename: concurrent writers (every
    host writes identical sidecars in a multi-process run) can never leave a
    torn file, and a crash mid-write never leaves a truncated sidecar."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# .xz payloads
# ---------------------------------------------------------------------------

def serialize_payload(shape, runs: np.ndarray, vals: np.ndarray) -> bytes:
    """Pack one box's compressed coefficients (compressor.cpp:55-80 layout)."""
    x, y, z = (int(v) for v in shape)
    if x * y * z > 0x7FFFFFFF:
        # the reference's int32 header field cannot represent it; a clean
        # error beats struct.error (outside the CLI's clean-error family)
        raise ValueError(
            f"box {x}x{y}x{z} has {x * y * z} coefficients — beyond the "
            "archive format's int32 total; split the domain into smaller "
            "boxes")
    n_pairs = len(runs)
    head = struct.pack("<5i", x, y, z, x * y * z, n_pairs)
    if n_pairs == 0:
        return head
    pairs = np.empty(n_pairs, dtype=np.dtype([("run", "<i4"), ("val", "<f4")]))
    pairs["run"] = runs
    pairs["val"] = vals
    return head + pairs.tobytes()


def deserialize_payload(data: bytes):
    """Unpack -> (shape (x,y,z), total_coeffs, runs int32[], vals f32[]).

    Malformed headers raise ValueError (a negative pair count would make
    ``np.frombuffer`` silently consume the rest of the buffer)."""
    if len(data) < 20:
        raise ValueError(f"payload truncated: {len(data)} bytes (< header)")
    x, y, z, total, n_pairs = struct.unpack_from("<5i", data, 0)
    if n_pairs < 0 or len(data) < 20 + n_pairs * 8:
        raise ValueError(
            f"corrupt payload header: {n_pairs} pairs, {len(data)} bytes")
    pairs = np.frombuffer(data, dtype=np.dtype([("run", "<i4"), ("val", "<f4")]),
                          count=n_pairs, offset=20)
    return (x, y, z), total, pairs["run"], pairs["val"]


def pack_preset(preset: int, delta: int = 0) -> int:
    """Pack (xz preset, delta-filter distance) into the single preset word
    every encode path (the port's, and the JAX package's native ABI)
    threads through: low byte = preset, next byte = delta distance (0 = no
    delta filter).

    Validated here so a typo can never silently encode a different
    setting (masking alone would turn e.g. xzdelta=-8 into distance 248).
    Distance 256 — legal in raw xz — is unsupported by the one-byte
    packing; payload strides here are 6 or 8 bytes, so nothing loses."""
    preset, delta = int(preset), int(delta)
    if not 0 <= preset <= 9:
        raise ValueError(f"xz preset must be 0-9, got {preset}")
    if not 0 <= delta <= 255:
        raise ValueError(
            f"xz delta distance must be 0-255 (0 = off), got {delta}")
    return preset | (delta << 8)


_LZMA_CHECK_CRC64 = 4


@functools.cache
def _buffer_encoder():
    """liblzma's ``lzma_easy_buffer_encode`` and ``lzma_stream_buffer_bound``
    through ctypes, or None where no liblzma loads.  A ctypes call runs
    without the GIL from start to end, where stdlib ``lzma`` holds it
    while it builds each encoder (~1 ms at preset 6): a packer's threads
    then encode small members one at a time."""
    try:
        lib = ctypes.CDLL(ctypes.util.find_library("lzma") or "liblzma.so.5")
        encode = lib.lzma_easy_buffer_encode
        bound = lib.lzma_stream_buffer_bound
    except (OSError, AttributeError):
        return None
    encode.argtypes = [ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_size_t), ctypes.c_size_t]
    encode.restype = ctypes.c_int
    bound.argtypes = [ctypes.c_size_t]
    bound.restype = ctypes.c_size_t
    return encode, bound


def _easy_buffer_encode(payload: bytes, preset: int):
    """``lzma_easy_buffer_encode(preset, LZMA_CHECK_CRC64)`` of ``payload``,
    or None where liblzma is not loaded or fails."""
    fns = _buffer_encoder()
    if fns is None:
        return None
    encode, bound = fns
    cap = bound(len(payload))
    out = ctypes.create_string_buffer(cap)
    pos = ctypes.c_size_t(0)
    if encode(preset, _LZMA_CHECK_CRC64, None, payload, len(payload), out,
              ctypes.byref(pos), cap) != 0:
        return None
    return out.raw[:pos.value]


def xz_compress(payload: bytes, preset: int = 6) -> bytes:
    """xz container, LZMA2 CRC64: the bytes of liblzma's buffer encoder
    (``lzma_easy_buffer_encode(p, CRC64)``, or ``lzma_stream_buffer_encode``
    over the delta + LZMA2 chain), as the native codec
    (native/wtc_codec.cpp:274-293) and the reference's compressor.cpp call
    it.  Preset 6 is the reference's; other presets are an extension
    (recorded in wtc-meta.json; the xz container itself is
    self-describing so any xz reader, including the reference, still
    decodes them).

    ``preset`` is the :func:`pack_preset` word: a nonzero high byte
    prepends xz's delta filter at that byte distance.  ``xzdelta=8``
    aligns with the 8-byte (int32 run, f32 value) pair stride and
    measured 2.3-3.5x smaller payloads on smooth-field coefficients
    (correlated float bit patterns); random-valued payloads are ~3-5%
    larger, so it is an opt-in knob.  Decoders need nothing: the filter
    chain is declared in the stream."""
    delta = (int(preset) >> 8) & 0xFF
    p = int(preset) & 0xFF
    blob = None if delta else _easy_buffer_encode(payload, p)
    if blob is not None:
        return blob
    return _stdlib_xz_compress(payload, p, delta)


def _stdlib_xz_compress(payload: bytes, p: int, delta: int) -> bytes:
    """:func:`xz_compress` through stdlib ``lzma``, reframed into the
    buffer encoder's bytes."""
    if delta:
        filters = [{"id": lzma.FILTER_DELTA, "dist": delta},
                   {"id": lzma.FILTER_LZMA2, "preset": p}]
    else:
        filters = [{"id": lzma.FILTER_LZMA2, "preset": p}]
    blob = lzma.compress(payload, format=lzma.FORMAT_XZ,
                         check=lzma.CHECK_CRC64, filters=filters)
    return _reframe_with_block_sizes(blob, payload)


def _read_varint(b: bytes, pos: int):
    v = 0
    shift = 0
    while True:
        c = b[pos]
        pos += 1
        v |= (c & 0x7F) << shift
        if not (c & 0x80):
            return v, pos
        shift += 7


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


# LZMA2's largest uncompressed chunk, and the stored block's filter entry:
# LZMA2 (id 0x21), one property byte, 0x00 = LZMA_DICT_SIZE_MIN
_LZMA2_CHUNK_MAX = 1 << 16
_STORED_FILTER = b"\x21\x01\x00"


def _lzma2_bound(n: int) -> int:
    """liblzma's ``lzma2_bound`` (block_buffer_encoder.c): ``n`` bytes as
    stored LZMA2 chunks, 3 header bytes a chunk, plus the end marker."""
    return n + 3 * -(-n // _LZMA2_CHUNK_MAX) + 1


def _stored_lzma2(payload: bytes) -> bytes:
    """liblzma's ``block_encode_uncompressed`` chunks: control 0x01 (a
    dictionary reset) for the first, 0x02 after it, the big-endian size
    less one, the bytes; then the 0x00 end marker."""
    out = bytearray()
    for s in range(0, len(payload), _LZMA2_CHUNK_MAX):
        chunk = payload[s:s + _LZMA2_CHUNK_MAX]
        out += bytes([0x01 if s == 0 else 0x02])
        out += (len(chunk) - 1).to_bytes(2, "big") + chunk
    out.append(0x00)
    return bytes(out)


def _reframe_with_block_sizes(blob: bytes, payload: bytes) -> bytes:
    """Rewrite stdlib ``lzma.compress``'s single-block xz stream of
    ``payload`` into the layout ``lzma_block_buffer_encode`` produces
    (the REFERENCE's encoder, compressor.cpp:250-291, and the native
    backend's).  Two things differ, and only the block header, its data
    where the second applies, the index and the footer are re-derived
    per the xz spec:

    - The buffer encoder's block header stores the compressed and
      uncompressed sizes; stdlib streams, so it omits them (found by the
      round-5 interop matrix).
    - Where the LZMA2 data exceeds ``lzma2_bound(n)`` (an incompressible
      payload: LZMA2 split it into more stored chunks than that many
      bytes need), the buffer encoder writes the block again as stored
      chunks, under LZMA2 alone at ``LZMA_DICT_SIZE_MIN``, also when the
      delta filter was asked for.

    The check, and otherwise the compressed bits and every filter entry,
    are copied verbatim.  Anything unexpected (multi-block,
    already-sized, foreign check) is returned unchanged."""
    import binascii

    try:
        if len(blob) < 32 or blob[:6] != b"\xfd7zXZ\x00":
            return blob
        check_type = blob[7]
        check_size = {0x00: 0, 0x01: 4, 0x04: 8, 0x0A: 32}.get(check_type)
        if check_size is None:
            return blob
        # footer: crc32(4) backward_size(4) flags(2) "YZ"(2)
        back = int.from_bytes(blob[-8:-4], "little")
        idx_size = (back + 1) * 4
        idx = blob[-12 - idx_size : -12]
        if not idx or idx[0] != 0x00:
            return blob
        nrec, p = _read_varint(idx, 1)
        if nrec != 1:
            return blob
        unpadded, p = _read_varint(idx, p)
        uncomp, p = _read_varint(idx, p)
        bh_start = 12
        old_bhs = (blob[bh_start] + 1) * 4
        flags = blob[bh_start + 1]
        if flags & 0xC0:
            return blob             # sizes already present
        nfilt = (flags & 0x03) + 1
        q = bh_start + 2
        for _ in range(nfilt):
            _fid, q = _read_varint(blob, q)
            props, q = _read_varint(blob, q)
            q += props
        filt_region = blob[bh_start + 2 : q]
        comp_size = unpadded - old_bhs - check_size
        data_start = bh_start + old_bhs
        data = blob[data_start : data_start + comp_size]
        check = blob[data_start + comp_size + (-comp_size % 4) :][
            :check_size]
        bound = _lzma2_bound(uncomp)
        if comp_size > bound:
            data, comp_size = _stored_lzma2(payload), bound
            flags, filt_region = 0x00, _STORED_FILTER
        # new block header: flags|0xC0 + size varints + filters + pad +
        # crc.  The buffer encoder sizes the header BEFORE compressing,
        # with the compressed-size varint of lzma2_bound(n), and zero-pads
        # whatever the real, smaller varint leaves unused; minimal headers
        # would differ from the reference tool's bytes.
        reserved = (2 + len(_varint(bound)) + len(_varint(uncomp))
                    + len(filt_region) + 4)
        new_bhs = (reserved + 3) // 4 * 4
        core = (bytes([flags | 0xC0]) + _varint(comp_size)
                + _varint(uncomp) + filt_region)
        hdr = bytes([new_bhs // 4 - 1]) + core
        hdr += b"\x00" * (new_bhs - 4 - len(hdr))
        hdr += binascii.crc32(hdr).to_bytes(4, "little")
        body = data + b"\x00" * (-comp_size % 4) + check
        # new index + footer
        new_idx = (b"\x00" + _varint(1)
                   + _varint(new_bhs + comp_size + check_size)
                   + _varint(uncomp))
        new_idx += b"\x00" * (-len(new_idx) % 4)
        new_idx += binascii.crc32(new_idx).to_bytes(4, "little")
        stream_flags = blob[6:8]
        back_raw = (len(new_idx) // 4 - 1).to_bytes(4, "little")
        footer = (binascii.crc32(back_raw + stream_flags)
                  .to_bytes(4, "little") + back_raw + stream_flags + b"YZ")
        return blob[:12] + hdr + body + new_idx + footer
    except (IndexError, ValueError):
        return blob


def _read_vli(b: bytes, pos: int, end: int):
    """xz's variable-length integer at ``pos``, or None where it runs past
    ``end``, past 9 bytes, or ends in a superfluous zero byte."""
    v = 0
    for k in range(9):
        if pos >= end:
            return None
        c = b[pos]
        pos += 1
        v |= (c & 0x7F) << (7 * k)
        if not c & 0x80:
            return (v, pos) if k == 0 or c else None
    return None


# LZMA2's dictionary sizes: property byte d <= 40 -> (2 | d & 1) << (d // 2
# + 11), and 40 -> 4 GiB - 1
def _lzma2_dict_size(d: int) -> int:
    return 0xFFFFFFFF if d == 40 else (2 | (d & 1)) << (d // 2 + 11)


def xz_single_block(blob: bytes):
    """The layout of ``blob`` where it is exactly what liblzma's buffer
    encoder writes without a delta filter: one stream with a CRC64 check,
    one block whose header carries both sizes and the LZMA2 filter alone,
    an uncompressed size no larger than the dictionary, and nothing after
    the stream footer.  -> ``(data_offset, compressed_size,
    uncompressed_size, crc64)``, the LZMA2 data and the check its output
    must meet, with every CRC32 of the container verified; or None for
    any other blob (the card declines it and :func:`xz_decompress` reads
    it)."""
    n = len(blob)
    if (n < 12 + 8 + 12 or blob[:6] != b"\xfd7zXZ\x00"
            or blob[6:8] != b"\x00\x04"
            or zlib.crc32(blob[6:8]) != int.from_bytes(blob[8:12], "little")):
        return None
    bhs = (blob[12] + 1) * 4
    hend = 12 + bhs
    if blob[12] == 0 or hend > n or blob[13] != 0xC0 or zlib.crc32(
            blob[12:hend - 4]) != int.from_bytes(blob[hend - 4:hend],
                                                 "little"):
        return None
    fields = []
    p = 14
    for _ in range(4):      # compressed, uncompressed, filter id, props size
        r = _read_vli(blob, p, hend - 4)
        if r is None:
            return None
        v, p = r
        fields.append(v)
    comp, unc, fid, nprops = fields
    if fid != 0x21 or nprops != 1 or p >= hend - 4 or blob[p] > 40:
        return None
    dict_size = _lzma2_dict_size(blob[p])
    if any(blob[p + 1:hend - 4]) or comp == 0 or unc > dict_size:
        return None
    pad = -comp % 4
    check = hend + comp + pad
    idx = check + 8
    if idx >= n or any(blob[hend + comp:check]):
        return None
    crc64 = int.from_bytes(blob[check:idx], "little")
    # the index: one record of (unpadded size, uncompressed size)
    if blob[idx] != 0x00:
        return None
    p = idx + 1
    for want in (1, bhs + comp + 8, unc):
        r = _read_vli(blob, p, n)
        if r is None or r[0] != want:
            return None
        p = r[1]
    iend = p + (-(p - idx) % 4)
    if iend + 4 + 12 != n or any(blob[p:iend]) or zlib.crc32(
            blob[idx:iend]) != int.from_bytes(blob[iend:iend + 4], "little"):
        return None
    foot = iend + 4
    back = int.from_bytes(blob[foot + 4:foot + 8], "little")
    if (zlib.crc32(blob[foot + 4:foot + 10]) != int.from_bytes(
            blob[foot:foot + 4], "little")
            or (back + 1) * 4 != iend + 4 - idx
            or blob[foot + 8:foot + 10] != blob[6:8]
            or blob[foot + 10:] != b"YZ"):
        return None
    return hend, comp, unc, crc64


def xz_decompress(blob: bytes) -> bytes:
    """Strict multi-stream xz decode, matching liblzma's
    LZMA_CONCATENATED semantics (the C++ codec in ``native/`` and the
    reference's decoder, decompressor.cpp:164-234): NUL stream padding in
    4-byte multiples is legal between/after streams, any other trailing
    bytes are an error.  stdlib ``lzma.decompress`` silently IGNORES trailing
    junk after a valid stream ("Leftover data ... ignore it"), which
    would make this decoder disagree with the C++ codec on corrupt
    members (found by the unpack fuzzer).  Errors are normalized to ValueError — the
    family cli.main's clean-error contract catches."""
    out = []
    data = bytes(blob)
    try:
        while True:
            d = lzma.LZMADecompressor(format=lzma.FORMAT_XZ)
            out.append(d.decompress(data))
            if not d.eof:
                raise ValueError("xz container truncated")
            rest = d.unused_data
            stripped = rest.lstrip(b"\x00")
            if (len(rest) - len(stripped)) % 4:
                raise ValueError("invalid xz stream padding")
            if not stripped:
                break
            data = stripped
    except lzma.LZMAError as e:
        raise ValueError(f"xz container decode failed: {e}") from e
    return b"".join(out)


# Raw-container frame: 4-byte magic + CRC32 of the payload.  xz carries
# CRC64 inside the stream; frameless raw would decode a bit-flipped
# coefficient silently, so raw members get the same integrity property for
# 8 bytes.  The magic makes the frame sniffable: legacy frameless blobs
# (whose first int32 is a box extent, never 0x52434357) still decode.
_RAW_MAGIC = b"WTCR"


def encode_blob(payload: bytes, codec: str = "xz", preset: int = 6) -> bytes:
    """Entropy stage selector: ``xz`` (reference format) or ``raw`` (no
    entropy coding — extension for hosts where xz is the pipeline
    bottleneck; ~1/5 the host cost for ~6x the bytes at 1% kept; framed
    with a CRC32 so corruption never decodes silently)."""
    if codec == "raw":
        return (_RAW_MAGIC
                + struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF)
                + payload)
    return xz_compress(payload, preset)


def decode_blob(blob: bytes, codec: str = "xz") -> bytes:
    if codec == "raw":
        if blob[:4] == _RAW_MAGIC:
            if len(blob) < 8:
                raise ValueError("raw container truncated (no CRC)")
            (want,) = struct.unpack("<I", blob[4:8])
            payload = blob[8:]
            if zlib.crc32(payload) & 0xFFFFFFFF != want:
                raise ValueError(
                    "raw payload CRC mismatch (corrupt archive member)")
            return payload
        return blob   # legacy frameless raw member
    return xz_decompress(blob)


def payload_filename(t: int, level: int, comp_idx: int, box: int) -> str:
    """File naming contract (compressor.cpp:250-254): comp_idx is the
    plotfile-Header component index (e.g. 6), preserved for interop."""
    return f"compressed-wavelet-{t}-{level}-{comp_idx}-{box}.xz"


_Q16 = np.dtype([("run", "<i4"), ("val", "<i2")])  # 6 bytes, unpadded


def serialize_payload_q16(shape, runs: np.ndarray, vals: np.ndarray) -> bytes:
    """Extended payload: kept values quantized to int16 (the reference's
    TODO.txt wishlist item).  Layout: the standard 5x int32 header, a
    float32 dequantization scale, then (int32 run, int16 q) pairs.  Only
    written when wtc-meta.json declares ``payload: "q16"`` — reference
    archives never contain it."""
    x, y, z = (int(v) for v in shape)
    if x * y * z > 0x7FFFFFFF:
        raise ValueError(
            f"box {x}x{y}x{z} has {x * y * z} coefficients — beyond the "
            "archive format's int32 total; split the domain into smaller "
            "boxes")
    n_pairs = len(runs)
    vals = np.asarray(vals, np.float32)
    if n_pairs and not np.isfinite(vals).all():
        # a quantized format cannot represent inf/NaN; silently encoding
        # them would store scale=inf/NaN and decode EVERY value in the
        # box as NaN.  The f32 payload path round-trips them faithfully.
        raise ValueError("payload=q16 cannot encode non-finite "
                         "coefficients; use the default f32 payload for "
                         "data containing inf/NaN")
    scale = float(np.max(np.abs(vals))) / 32767.0 if n_pairs else 0.0
    head = struct.pack("<5if", x, y, z, x * y * z, n_pairs, scale)
    if n_pairs == 0:
        return head
    if scale == 0.0:
        # every kept value is exactly 0.0 (threshold 0): q must be all
        # zeros, not the 0/0 NaN an unguarded divide would cast to int16
        q = np.zeros(n_pairs, np.float32)
    else:
        q = np.clip(np.rint(vals / np.float32(scale)), -32767, 32767)
    pairs = np.empty(n_pairs, dtype=_Q16)
    pairs["run"] = runs
    pairs["val"] = q.astype(np.int16)
    return head + pairs.tobytes()


def deserialize_payload_q16(data: bytes):
    if len(data) < 24:
        raise ValueError(f"payload truncated: {len(data)} bytes (< header)")
    x, y, z, total, n_pairs, scale = struct.unpack_from("<5if", data, 0)
    if n_pairs < 0 or len(data) < 24 + n_pairs * 6:
        raise ValueError(
            f"corrupt payload header: {n_pairs} pairs, {len(data)} bytes")
    pairs = np.frombuffer(data, dtype=_Q16, count=n_pairs, offset=24)
    vals = pairs["val"].astype(np.float32) * np.float32(scale)
    return (x, y, z), total, pairs["run"], vals


# ---------------------------------------------------------------------------
# extension metadata sidecar (new; unknown to and ignored by the reference)
# ---------------------------------------------------------------------------

META_NAME = "wtc-meta.json"


def write_meta(path: str, *, threshold_mode: str = "box", keep: float = None,
               keep_fraction: float = None, scales: int = 1,
               payload: str = "f32", codec: str = "xz", xz_preset: int = 6,
               archive_format: str = "files", xz_delta: int = 0):
    """Record extension settings so decompression is self-describing.

    A reference-compatible archive (default settings) also gets the file —
    the reference tool reads only its five fixed names, so the extra sidecar
    is invisible to it; our decompressor defaults to reference semantics
    when the file is absent."""
    import json

    meta = {"format_version": 1, "threshold_mode": threshold_mode,
            "scales": int(scales), "payload": payload, "codec": codec,
            "xz_preset": int(xz_preset), "archive": archive_format}
    if xz_delta:
        # informational: decode never needs it (the xz stream declares
        # its own filter chain)
        meta["xz_delta"] = int(xz_delta)
    if keep is not None:
        meta["keep"] = float(keep)
    if keep_fraction is not None:
        meta["keep_fraction"] = float(keep_fraction)
    # integrity extension: CRC32 of each metadata sidecar present at write
    # time — the reference's .raw sidecars carry no checksums, so a bit
    # flip in locations.raw would silently shift geometry; -check verifies
    # these when the key exists (hand-assembled/reference archives without
    # the meta file are unaffected)
    crcs = {}
    for name in ("runinfo.raw", "locations.raw", "dimensions.raw",
                 "boxcounts.raw", "amrexinfo.raw"):
        p = os.path.join(path, name)
        if os.path.exists(p):
            with open(p, "rb") as f:
                crcs[name] = zlib.crc32(f.read()) & 0xFFFFFFFF
    if crcs:
        meta["sidecar_crc32"] = crcs
    _atomic_write_bytes(os.path.join(path, META_NAME),
                        json.dumps(meta).encode())


def read_meta(path: str) -> dict:
    import json

    p = os.path.join(path, META_NAME)
    if not os.path.exists(p):
        return {"format_version": 0, "threshold_mode": "box", "scales": 1,
                "payload": "f32", "codec": "xz", "xz_preset": 6,
                "archive": "files"}
    with open(p) as f:
        try:
            meta = json.load(f)
        except ValueError as e:   # JSONDecodeError; name the file for the user
            raise ValueError(f"corrupt archive metadata {p}: {e}") from None
    if not isinstance(meta, dict):
        raise ValueError(f"corrupt archive metadata {p}: expected a JSON "
                         f"object, got {type(meta).__name__}")
    meta.setdefault("archive", "files")
    return meta


# ---------------------------------------------------------------------------
# primitive (de)serializers — layouts of readandwrite.cpp:11-196
# ---------------------------------------------------------------------------

class _Writer:
    def __init__(self):
        self.parts = []

    def u64(self, v):  # size_t
        self.parts.append(struct.pack("<Q", int(v)))

    def i32(self, v):
        self.parts.append(struct.pack("<i", int(v)))

    def f32(self, v):
        self.parts.append(struct.pack("<f", float(v)))

    def f64(self, v):
        self.parts.append(struct.pack("<d", float(v)))

    def f80(self, v):
        # x86-64 long double: 80-bit extended padded to 16 bytes.  numpy
        # leaves the 6 padding bytes as allocator garbage (as does the
        # reference's raw fwrite of a long double) — zero them so archive
        # bytes are deterministic across processes and runs
        raw = np.asarray([v], dtype=np.longdouble).tobytes()
        buf = bytearray(len(raw))
        buf[:10] = raw[:10]
        self.parts.append(bytes(buf))

    def string(self, s: str):
        b = s.encode()
        self.u64(len(b))
        self.parts.append(b)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


class _Reader:
    """Bounds-checked reader: truncated/corrupt sidecars raise ValueError
    with a descriptive message instead of escaping as StopIteration /
    IndexError / struct.error (cli.main turns ValueError into a clean
    fatal log, not a traceback)."""

    def __init__(self, data: bytes, name: str = "sidecar"):
        self.data = data
        self.off = 0
        self.name = name

    def _need(self, n: int):
        if self.off + n > len(self.data):
            raise ValueError(
                f"truncated or corrupt {self.name}: needed {n} bytes at "
                f"offset {self.off}, file has {len(self.data)}")

    def _take(self, fmt):
        self._need(struct.calcsize(fmt))
        v = struct.unpack_from(fmt, self.data, self.off)[0]
        self.off += struct.calcsize(fmt)
        return v

    def u64(self):
        return self._take("<Q")

    def i32(self):
        return self._take("<i")

    def f32(self):
        return self._take("<f")

    def f64(self):
        return self._take("<d")

    def f80(self):
        self._need(np.dtype(np.longdouble).itemsize)
        v = np.frombuffer(self.data, dtype=np.longdouble, count=1,
                          offset=self.off)[0]
        self.off += np.dtype(np.longdouble).itemsize
        return v

    def string(self) -> str:
        n = self.u64()
        self._need(n)
        s = self.data[self.off : self.off + n].decode()
        self.off += n
        return s


# ---------------------------------------------------------------------------
# sidecar files
# ---------------------------------------------------------------------------

class RunInfo:
    """Reference ``RunInfo`` (box-structs.h:22-28)."""

    def __init__(self, files, min_level, max_level, components, comp_idxs):
        self.files = list(files)
        self.min_level = int(min_level)
        self.max_level = int(max_level)
        self.components = list(components)
        self.comp_idxs = list(comp_idxs)

    def __eq__(self, other):
        return (self.files == other.files and self.min_level == other.min_level
                and self.max_level == other.max_level
                and self.components == other.components
                and self.comp_idxs == other.comp_idxs)


def write_runinfo(info: RunInfo, path: str, name: str = "runinfo.raw"):
    """Layout of readandwrite.cpp:362-376."""
    w = _Writer()
    w.u64(len(info.files))
    for s in info.files:
        w.string(s)
    w.i32(info.min_level)
    w.i32(info.max_level)
    w.u64(len(info.components))
    for s in info.components:
        w.string(s)
    w.u64(len(info.comp_idxs))
    for v in info.comp_idxs:
        w.i32(v)
    _atomic_write_bytes(os.path.join(path, name), w.getvalue())


def read_runinfo(path: str, name: str = "runinfo.raw") -> RunInfo:
    r = _Reader(open(os.path.join(path, name), "rb").read(), name)
    files = [r.string() for _ in range(r.u64())]
    min_level = r.i32()
    max_level = r.i32()
    components = [r.string() for _ in range(r.u64())]
    comp_idxs = [r.i32() for _ in range(r.u64())]
    return RunInfo(files, min_level, max_level, components, comp_idxs)


def write_locdim(data, path: str, name: str):
    """``locations.raw``/``dimensions.raw``: 3 float32 per box in (t, lev, box)
    iteration order — ints stored as floats, faithfully reproducing
    readandwrite.cpp:226-242 (SURVEY.md §5.6 quirk 5: corrupts > 2^24)."""
    flat = []
    for per_t in data:
        for per_lev in per_t:
            for triple in per_lev:
                flat.extend(float(v) for v in triple[:3])
    _atomic_write_bytes(os.path.join(path, name),
                        np.asarray(flat, dtype=np.float32).tobytes())


def read_locdim(path: str, name: str, box_counts):
    """-> nested [t][lev][box] int triples (readandwrite.cpp:246-269)."""
    raw = np.fromfile(os.path.join(path, name), dtype=np.float32)
    need = 3 * sum(int(c) for per in box_counts for c in per)
    if len(raw) < need:
        raise ValueError(
            f"truncated or corrupt {name}: boxcounts.raw implies "
            f"{need} float32 entries, file has {len(raw)}")
    used = raw[:need]
    # same float-stored-int hazard as boxcounts (quirk §4.2): a corrupt
    # inf raises OverflowError from int() — outside the clean-error
    # family — and values past 2^24 aren't integer-exact float32 anyway
    if need and (not np.isfinite(used).all()
                 or (np.abs(used) >= 2**24).any()):
        raise ValueError(f"corrupt {name}: non-finite or absurd entry")
    out, k = [], 0
    for per_lev_counts in box_counts:
        t_list = []
        for count in per_lev_counts:
            lev_list = []
            for _ in range(count):
                lev_list.append(tuple(int(v) for v in raw[k : k + 3]))
                k += 3
            t_list.append(lev_list)
        out.append(t_list)
    return out


def write_boxcounts(counts, path: str, name: str = "boxcounts.raw"):
    """num_times x num_levels counts as float32 (readandwrite.cpp:273-291)."""
    flat = [float(c) for per_t in counts for c in per_t]
    _atomic_write_bytes(os.path.join(path, name),
                        np.asarray(flat, dtype=np.float32).tobytes())


def read_boxcounts(path: str, num_times: int, num_levels: int,
                   name: str = "boxcounts.raw"):
    raw = np.fromfile(os.path.join(path, name), dtype=np.float32)
    if len(raw) < num_times * num_levels:
        raise ValueError(
            f"truncated or corrupt {name}: expected {num_times}x{num_levels} "
            f"counts, file has {len(raw)}")
    used = raw[: num_times * num_levels]
    # counts are float-stored (reference quirk §4.2): a corrupt NaN/inf/
    # huge float would cast to an undefined int64 silently; float32 holds
    # integers exactly only below 2^24, so anything above it is corrupt
    # regardless
    if not np.isfinite(used).all() or (np.abs(used) >= 2**24).any():
        raise ValueError(f"corrupt {name}: non-finite or absurd box count")
    counts = used.astype(np.int64)
    if (counts < 0).any():
        raise ValueError(f"corrupt {name}: negative box count")
    return counts.reshape(num_times, num_levels).tolist()


class AMReXInfo:
    """Reference ``AMReXInfo`` (box-structs.h:42-50): geometry + times needed
    to regenerate plotfiles."""

    def __init__(self, geomcellinfo, ref_ratios, true_times, level_steps,
                 x_dim, y_dim, z_dim):
        self.geomcellinfo = [list(map(float, g)) for g in geomcellinfo]
        self.ref_ratios = [int(v) for v in ref_ratios]
        self.true_times = list(true_times)  # np.longdouble preserved
        self.level_steps = [[int(v) for v in ls] for ls in level_steps]
        self.x_dim = int(x_dim)
        self.y_dim = int(y_dim)
        self.z_dim = int(z_dim)


def write_amrexinfo(info: AMReXInfo, path: str, name: str = "amrexinfo.raw"):
    """Layout of readandwrite.cpp:321-338."""
    w = _Writer()
    w.u64(len(info.geomcellinfo))
    for vec in info.geomcellinfo:
        w.u64(len(vec))
        for v in vec:
            w.f64(v)
    w.u64(len(info.ref_ratios))
    for v in info.ref_ratios:
        w.i32(v)
    w.u64(len(info.true_times))
    for v in info.true_times:
        w.f80(v)
    w.u64(len(info.level_steps))
    for vec in info.level_steps:
        w.u64(len(vec))
        for v in vec:
            w.i32(v)
    w.i32(info.x_dim)
    w.i32(info.y_dim)
    w.i32(info.z_dim)
    _atomic_write_bytes(os.path.join(path, name), w.getvalue())


def read_amrexinfo(path: str, name: str = "amrexinfo.raw") -> AMReXInfo:
    r = _Reader(open(os.path.join(path, name), "rb").read(), name)
    geom = []
    for _ in range(r.u64()):
        geom.append([r.f64() for _ in range(r.u64())])
    ref_ratios = [r.i32() for _ in range(r.u64())]
    true_times = [r.f80() for _ in range(r.u64())]
    level_steps = []
    for _ in range(r.u64()):
        level_steps.append([r.i32() for _ in range(r.u64())])
    return AMReXInfo(geom, ref_ratios, true_times, level_steps,
                     r.i32(), r.i32(), r.i32())
