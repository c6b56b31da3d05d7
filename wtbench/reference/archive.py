"""A plain reader of the program's archives, to judge what they hold.

Members are ``compressed-wavelet-{t}-{level}-{comp}-{box}.xz`` files, or
the same bytes inside ``bundle-t{T}-p{P}[-g{G}].wtb`` containers: the
magic ``WTB1``, the members, an index of ``n`` entries ``int32 t, level,
comp, box; int64 offset, size`` and a trailer ``int64 index offset, int64
n, WTB1``.  A member is one xz stream with a CRC64 check around the
payload that ``reference.codec.payloads`` builds, or, with ``codec=raw``,
the magic ``WTCR``, the payload's CRC32 and the payload.
"""

from __future__ import annotations

import lzma
import os
import re
import struct
import zlib

_FILE_RE = re.compile(r"^compressed-wavelet-(\d+)-(\d+)-(\d+)-(\d+)\.xz$")
_BUNDLE_RE = re.compile(r"^bundle-t(\d+)-p(\d+)(?:-g(\d+))?\.wtb$")
_ENTRY = struct.Struct("<iiiiqq")
_TRAILER = struct.Struct("<qq4s")
MAGIC = b"WTB1"
RAW_MAGIC = b"WTCR"


def _bundle_index(path: str) -> list:
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path}: bad magic")
        f.seek(size - _TRAILER.size)
        off, n, magic = _TRAILER.unpack(f.read(_TRAILER.size))
        if magic != MAGIC or off + n * _ENTRY.size + _TRAILER.size != size:
            raise ValueError(f"{path}: bad trailer")
        f.seek(off)
        data = f.read(n * _ENTRY.size)
    out = []
    for k in range(n):
        t, lev, comp, box, moff, msize = _ENTRY.unpack_from(data, k * _ENTRY.size)
        if moff < 4 or msize < 0 or moff + msize > off:
            raise ValueError(f"{path}: member {k} out of bounds")
        out.append(((t, lev, comp, box), (path, moff, msize)))
    return out


def members(dir_: str) -> dict:
    """``(t, level, comp, box) -> (path, offset, size)`` of every member
    in an archive directory; a later bundle generation wins."""
    found = {}
    bundles = []
    for name in os.listdir(dir_):
        m = _FILE_RE.match(name)
        if m:
            path = os.path.join(dir_, name)
            found[tuple(int(v) for v in m.groups())] = (
                path, 0, os.path.getsize(path))
            continue
        m = _BUNDLE_RE.match(name)
        if m:
            bundles.append(((int(m.group(1)), int(m.group(2)),
                             int(m.group(3) or 0)), name))
    for _key, name in sorted(bundles):
        found.update(_bundle_index(os.path.join(dir_, name)))
    return found


def read(loc) -> bytes:
    path, off, size = loc
    with open(path, "rb") as f:
        f.seek(off)
        return f.read(size)


def decode(blob: bytes) -> bytes:
    """The payload of one member: one complete xz stream with a CRC64
    check and nothing after it, or a raw member whose CRC32 holds."""
    if blob[:4] == RAW_MAGIC:
        (want,) = struct.unpack("<I", blob[4:8])
        if zlib.crc32(blob[8:]) != want:
            raise ValueError("raw member's CRC32 does not hold")
        return blob[8:]
    d = lzma.LZMADecompressor(format=lzma.FORMAT_XZ)
    try:
        out = d.decompress(blob)
    except lzma.LZMAError as e:
        raise ValueError(f"not an xz stream: {e}") from None
    if not d.eof or d.unused_data:
        raise ValueError("not exactly one complete xz stream")
    if d.check != lzma.CHECK_CRC64:
        raise ValueError(f"xz check {d.check}, not CRC64")
    return out


def dir_bytes(dir_: str) -> int:
    """Bytes of every file in an archive directory: what a user stores."""
    return sum(os.path.getsize(os.path.join(dir_, n)) for n in os.listdir(dir_)
               if os.path.isfile(os.path.join(dir_, n)))
