"""Bundled payload container (``archive=bundle`` extension).

The port's own copy of ``wavelet_tpu/io/bundle.py``,
unchanged but for its imports, so that the port imports nothing of
``wavelet_tpu``.

The reference writes one ``.xz`` file per (t, level, component, box)
(compressor.cpp:250-291) — thousands of tiny files for real AMR datasets,
whose per-file open/write/rename cost dominates the host stage once the
codec itself runs at memory speed (see BASELINE.md ``fs_overhead``).  The
bundle mode concatenates the *identical* member payload bytes into one
append-only container per (timestep, writer process):

    bundle-t{T}-p{P}[-g{G}].wtb
    ┌──────────────────────────────────────────────┐
    │ magic  b"WTB1"                               │
    │ member blob 0  (== the per-file bytes)       │
    │ member blob 1                                │
    │ ...                                          │
    │ index: n × {int32 t, lev, comp_idx, box;     │
    │             int64 offset, size}              │
    │ trailer: int64 index_offset, int64 n_members,│
    │          magic b"WTB1"                       │
    └──────────────────────────────────────────────┘

Each member blob is byte-for-byte what the per-file mode would have written
to ``compressed-wavelet-{t}-{lev}-{comp}-{box}.xz`` — the container is a
pure filesystem-level change, declared in ``wtc-meta.json`` so decompress /
check auto-detect it; default archives stay reference-compatible per-file.

Durability: bundles are written to a ``.tmp`` name and renamed on close, so
a crash never leaves a readable-but-partial bundle; resume treats finished
bundles as immutable and appends a new generation (``-g{G}``) for the
remaining items.
"""

from __future__ import annotations

import os
import re
import struct
import threading

__all__ = ["BundleWriter", "BundleSet", "bundle_name", "list_bundles",
           "read_index", "MAGIC"]

MAGIC = b"WTB1"
_INDEX_ENTRY = struct.Struct("<iiiiqq")        # t, lev, comp, box, off, size
_TRAILER = struct.Struct("<qq4s")              # index_offset, n_members, magic
_NAME_RE = re.compile(r"^bundle-t(\d+)-p(\d+)(?:-g(\d+))?\.wtb$")


def bundle_name(t: int, process: int, generation: int = 0) -> str:
    if generation:
        return f"bundle-t{t:05d}-p{process}-g{generation}.wtb"
    return f"bundle-t{t:05d}-p{process}.wtb"


def list_bundles(dir_: str):
    """Bundle file names in ``dir_`` ordered by (timestep, process,
    generation) — completed ones only, in-flight ``.tmp`` files don't
    match.  Parsed-key order (not lexicographic: ``-g1`` would sort
    *before* its base name) so later generations come last and win any
    member-key collision in :class:`BundleSet`."""
    try:
        entries = os.listdir(dir_)
    except FileNotFoundError:
        return []
    keyed = []
    for name in entries:
        m = _NAME_RE.match(name)
        if m:
            # the file name itself tie-breaks an explicit "-g0" vs its
            # suffix-less equivalent (same parsed key) so collision
            # resolution never depends on os.listdir order
            keyed.append(((int(m.group(1)), int(m.group(2)),
                           int(m.group(3) or 0), name), name))
    return [name for _k, name in sorted(keyed)]


class BundleWriter:
    """Append-only writer for one bundle file.  Thread-safe appends; the
    member order on disk is whatever order ``add`` is called in (callers
    append in item order for deterministic archives)."""

    def __init__(self, path: str):
        self.path = path
        self._tmp = path + ".tmp"
        self._f = open(self._tmp, "wb")
        self._f.write(MAGIC)
        self._pos = len(MAGIC)
        self._index = []
        self._lock = threading.Lock()
        self._closed = False

    def add(self, t: int, level: int, comp_idx: int, box: int,
            blob: bytes) -> int:
        """Append one member; returns its size."""
        with self._lock:
            self._f.write(blob)
            self._index.append((t, level, comp_idx, box,
                                self._pos, len(blob)))
            self._pos += len(blob)
        return len(blob)

    def __len__(self):
        return len(self._index)

    def close(self) -> int:
        """Write index + trailer, fsync-rename into place.  Returns total
        file bytes.  A bundle with zero members is deleted, not renamed.

        Durability order: data+index+trailer are fsync'd BEFORE the
        rename, and the directory entry after it — otherwise a crash
        can commit the rename while the data blocks are still unflushed,
        leaving a bundle at its FINAL name with torn bytes that resume
        (which treats finished bundles as immutable) would never
        rewrite.  Serialized with ``add`` via the same lock: ``add`` is
        advertised thread-safe, and an in-flight append interleaving
        with the index write would silently shift every index offset."""
        with self._lock:
            if self._closed:
                return 0
            self._closed = True
            if not self._index:
                self._f.close()
                os.remove(self._tmp)
                return 0
            index_off = self._pos
            for entry in self._index:
                self._f.write(_INDEX_ENTRY.pack(*entry))
            self._f.write(_TRAILER.pack(index_off, len(self._index), MAGIC))
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
            os.replace(self._tmp, self.path)
            dfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
            return (index_off + len(self._index) * _INDEX_ENTRY.size
                    + _TRAILER.size)

    def abort(self):
        if not self._closed:
            self._closed = True
            self._f.close()
            os.remove(self._tmp)


def read_index(path: str):
    """[(t, lev, comp_idx, box, offset, size)] of one bundle.

    Raises ValueError on a malformed container (bad magic/trailer, index
    out of bounds) — the descriptive-error contract of the sidecar readers.
    """
    size = os.path.getsize(path)
    if size < len(MAGIC) + _TRAILER.size:
        raise ValueError(f"{path}: too short for a bundle container")
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: bad bundle magic")
        f.seek(size - _TRAILER.size)
        index_off, n, magic = _TRAILER.unpack(f.read(_TRAILER.size))
        if magic != MAGIC:
            raise ValueError(f"{path}: bad bundle trailer (truncated?)")
        index_bytes = n * _INDEX_ENTRY.size
        if (n < 0 or index_off < len(MAGIC)
                or index_off + index_bytes + _TRAILER.size != size):
            raise ValueError(f"{path}: bundle index out of bounds")
        f.seek(index_off)
        data = f.read(index_bytes)
    entries = []
    for k in range(n):
        entry = _INDEX_ENTRY.unpack_from(data, k * _INDEX_ENTRY.size)
        off, bsize = entry[4], entry[5]
        if off < len(MAGIC) or bsize < 0 or off + bsize > index_off:
            raise ValueError(f"{path}: member {k} out of bounds")
        entries.append(entry)
    return entries


class BundleSet:
    """Read-side view over every bundle in an archive directory: maps
    (t, lev, comp_idx, box) -> member bytes.

    Bundle files are opened lazily and kept open (decompress walks them
    timestep by timestep); members duplicated across bundles resolve to the
    later bundle in sorted name order (generations sort after their base —
    last-writer-wins, matching the per-file mode's overwrite semantics).
    """

    def __init__(self, dir_: str):
        self.dir = dir_
        self._members = {}
        self._handles = {}
        self._lock = threading.Lock()
        for name in list_bundles(dir_):
            path = os.path.join(dir_, name)
            for (t, lev, comp, box, off, size) in read_index(path):
                self._members[(t, lev, comp, box)] = (path, off, size)

    def __contains__(self, key) -> bool:
        return tuple(key) in self._members

    def __len__(self):
        return len(self._members)

    def keys(self):
        return self._members.keys()

    def locate(self, t: int, level: int, comp_idx: int, box: int):
        """(path, offset, size) of a member, or None."""
        return self._members.get((t, level, comp_idx, box))

    def blob(self, t: int, level: int, comp_idx: int, box: int) -> bytes:
        loc = self._members.get((t, level, comp_idx, box))
        if loc is None:
            raise FileNotFoundError(
                f"no bundle member for (t={t}, level={level}, "
                f"comp={comp_idx}, box={box}) under {self.dir}")
        path, off, size = loc
        with self._lock:
            f = self._handles.get(path)
            if f is None:
                f = self._handles[path] = open(path, "rb")
            f.seek(off)
            return f.read(size)

    def close(self):
        with self._lock:
            for f in self._handles.values():
                f.close()
            self._handles.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
