"""Compressed-archive byte formats: sidecar files and per-box ``.xz`` payloads.

The port's own copy of ``wavelet_tpu/io/archive.py``,
unchanged but for its imports, so that the port imports nothing of
``wavelet_tpu``.

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

LZMA parameters match ``lzma_easy_encoder(6, LZMA_CHECK_CRC64)``.

Note: the reference computes a ``need32`` flag but never serializes it
(box-structs.h:69, SURVEY.md §4.2 quirk); the format has no such field and we
don't reproduce the dead flag.
"""

from __future__ import annotations

import lzma
import os
import struct
import zlib

import numpy as np

__all__ = [
    "RunInfo", "AMReXInfo",
    "serialize_payload", "deserialize_payload",
    "serialize_payload_q16", "deserialize_payload_q16",
    "xz_compress", "xz_decompress", "encode_blob", "decode_blob",
    "payload_filename",
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
    every encode path (Python and the native ABI) already threads through:
    low byte = preset, next byte = delta distance (0 = no delta filter).

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


def xz_compress(payload: bytes, preset: int = 6) -> bytes:
    """xz container, LZMA2 CRC64 — at preset 6, byte-matching
    lzma_easy_encoder(6, CRC64); other presets are an extension (recorded
    in wtc-meta.json; the xz container itself is self-describing so any
    xz reader, including the reference, still decodes them).

    ``preset`` is the :func:`pack_preset` word: a nonzero high byte
    prepends xz's delta filter at that byte distance.  ``xzdelta=8``
    aligns with the 8-byte (int32 run, f32 value) pair stride and
    measured 2.3-3.5x smaller payloads on smooth-field coefficients
    (correlated float bit patterns); random-valued payloads are ~3-5%
    larger, so it is an opt-in knob.  Decoders need nothing: the filter
    chain is declared in the stream."""
    delta = (int(preset) >> 8) & 0xFF
    p = int(preset) & 0xFF
    if delta:
        filters = [{"id": lzma.FILTER_DELTA, "dist": delta},
                   {"id": lzma.FILTER_LZMA2, "preset": p}]
    else:
        filters = [{"id": lzma.FILTER_LZMA2, "preset": p}]
    blob = lzma.compress(payload, format=lzma.FORMAT_XZ,
                         check=lzma.CHECK_CRC64, filters=filters)
    return _reframe_with_block_sizes(blob)


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


def _reframe_with_block_sizes(blob: bytes) -> bytes:
    """Rewrite a single-block xz stream so its block header stores the
    compressed + uncompressed sizes — the layout ``lzma_easy_buffer_
    encode`` produces (the REFERENCE's encoder, compressor.cpp:250-291,
    and our native backend's).  stdlib ``lzma.compress`` streams, so it
    omits the sizes; without this reframe the python backend's containers
    decode identically everywhere but differ byte-wise from both the
    native backend and the C++ tool (found by the round-5 interop
    matrix).  The compressed bits, check, and every filter entry are
    copied verbatim — only the block header, index and footer are
    re-derived per the xz spec.  Anything unexpected (multi-block,
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
        body = blob[bh_start + old_bhs : bh_start + old_bhs
                    + comp_size + (-comp_size % 4) + check_size]
        # new block header: flags|0xC0 + size varints + filters + pad +
        # crc.  liblzma's buffer encoder sizes the header BEFORE
        # compressing — it reserves varint space for
        # lzma_block_buffer_bound(uncomp) (= align4(n) + 96 + 3*(n>>16),
        # probed from the system liblzma) and zero-pads whatever the
        # real, smaller compressed-size varint leaves unused; minimal
        # headers would differ from the reference tool's bytes.
        bound = (uncomp + 3) // 4 * 4 + 96 + 3 * (uncomp >> 16)
        reserved = (2 + len(_varint(bound)) + len(_varint(uncomp))
                    + len(filt_region) + 4)
        new_bhs = (reserved + 3) // 4 * 4
        core = (bytes([flags | 0xC0]) + _varint(comp_size)
                + _varint(uncomp) + filt_region)
        hdr = bytes([new_bhs // 4 - 1]) + core
        hdr += b"\x00" * (new_bhs - 4 - len(hdr))
        hdr += binascii.crc32(hdr).to_bytes(4, "little")
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


def xz_decompress(blob: bytes) -> bytes:
    """Strict multi-stream xz decode, matching liblzma's
    LZMA_CONCATENATED semantics (the native backend and the reference's
    decoder, decompressor.cpp:164-234): NUL stream padding in 4-byte
    multiples is legal between/after streams, any other trailing bytes
    are an error.  stdlib ``lzma.decompress`` silently IGNORES trailing
    junk after a valid stream ("Leftover data ... ignore it"), which
    would make the two backends disagree on corrupt members (found by
    the unpack fuzzer).  Errors are normalized to ValueError — the
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
