"""Shape-bucketed batching of ragged AMR boxes.

The port's own copy of ``wavelet_tpu/runtime/batching.py``,
unchanged but for its imports, so that the port imports nothing of
``wavelet_tpu``.

XLA wants static shapes and large batches; AMR gives ragged per-level box
shapes (the fixture mixes 16x32x64 and 8x4x2 at one level).  The plan here
flattens the reference's (t, level, component, box) iteration space
(iterator.h:25-33) into one work item per *(box, component)* pair — every
item is codec-independent (SURVEY.md §2: embarrassing parallelism) — then
buckets items by box shape into dense ``[N, X, Y, Z]`` batches, padding N up
to a multiple of the mesh size so the leading axis shards evenly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import threading

import numpy as np

__all__ = ["WorkItem", "ShapeBatch", "plan_batches", "pad_to_multiple",
           "cap_pack"]


@dataclass(frozen=True)
class WorkItem:
    """One (timestep, level, header-component-index, box-index) codec unit."""

    t: int
    level: int
    comp_idx: int     # plotfile-Header component index (file-name contract)
    box: int


@dataclass
class ShapeBatch:
    """A dense batch of same-shape items.

    ``pack == 1``: ``data`` is ``[N, X, Y, Z]`` and ``data[i]`` belongs to
    ``items[i]``.  ``pack == P > 1`` (TPU lane-packed layout): ``data`` is
    ``[N//P, X, Y, P*Z]`` and item i lives at
    ``data[i // P, :, :, (i % P)*Z : (i % P + 1)*Z]`` — P boxes' Z-axes
    fill the 128-lane dimension, which is what makes the fused Pallas
    kernels DMA-efficient (kernels/haar_pallas.py).

    ``n_valid`` <= N marks the unpadded prefix; padded slots are zeros and
    are ignored when unpacking results.
    """

    shape: tuple
    data: np.ndarray
    items: list               # length n_valid
    n_valid: int
    pack: int = 1
    # coefficient layout: "halves" = each axis deinterleaved into
    # (low half, high half) — the reference's order; "interleaved" = lows
    # at even, highs at odd indices (the in-place kernel layout; the host
    # packer walks kernels/haar_pallas.interleave_perm to recover the
    # reference byte order).  ``scales`` is the pyramid depth the layout
    # encodes (the multi-scale interleaved map is non-separable; see
    # haar_pallas.interleave_coords_multi).  Spatial (non-coefficient)
    # batches are always natural order and keep the defaults.
    layout: str = "halves"
    scales: int = 1
    # lazily built caches, EXCLUDED from dataclasses.replace (init=False):
    # both depend on (pack, scales, layout), which the engine routinely
    # rewrites via replace() — carrying a stale cache across a geometry
    # change would read coefficients at wrong offsets with no error
    _map_cache: object = field(default=None, init=False, repr=False,
                               compare=False)
    _offsets_cache: object = field(default=None, init=False, repr=False,
                                   compare=False)

    def _logical_map(self):
        """Flat logical->physical element offsets within an item region
        (cached: it is O(X*Y*Z) to build and shared by every item)."""
        if self._map_cache is None:
            # the map lives in the JAX package's Pallas module; the port
            # keeps every coefficient batch in the halves layout
            raise NotImplementedError(
                "the interleaved coefficient layout is not ported")
        return self._map_cache

    def item_view(self, i: int) -> np.ndarray:
        """Item i's (X, Y, Z) array in LOGICAL (reference) order.

        A view into ``data`` for natural layouts; a gathered copy for
        ``layout == "interleaved"`` coefficient batches."""
        phys = self._item_phys(i)
        if self.layout != "interleaved":
            return phys
        x, y, z = self.shape
        off = int(self.item_offsets()[i])
        flat = self.data.reshape(-1)
        return flat[off + self._logical_map()].reshape(x, y, z)

    def _item_phys(self, i: int) -> np.ndarray:
        """Item i's physical (X, Y, Z) region (always a view)."""
        if self.pack == 1:
            return self.data[i]
        z = self.shape[-1]
        m, p = divmod(i, self.pack)
        return self.data[m, :, :, p * z : (p + 1) * z]

    def item_write(self, i: int, logical: np.ndarray) -> None:
        """Store item i from a LOGICAL-order (X, Y, Z) array (scatters
        through the interleave map when needed)."""
        if self.layout != "interleaved":
            self._item_phys(i)[:] = logical
            return
        off = int(self.item_offsets()[i])
        flat = self.data.reshape(-1)
        flat[off + self._logical_map()] = logical.reshape(-1)

    def item_offsets(self) -> np.ndarray:
        """Flat-element offset of each item's first coefficient (for the
        strided native codec); row geometry = (X*Y rows of Z, stride P*Z).
        Cached — per-item accessors call this once per item."""
        if self._offsets_cache is None:
            x, y, z = self.shape
            n = len(self.items)
            idx = np.arange(n, dtype=np.int64)
            if self.pack == 1:
                self._offsets_cache = idx * (x * y * z)
            else:
                m, p = np.divmod(idx, self.pack)
                self._offsets_cache = m * (x * y * self.pack * z) + p * z
        return self._offsets_cache


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m if m > 1 else n


def cap_pack(pack: int, n_items: int, z: int | None = None) -> int:
    """Halve an over-wide lane-pack factor until it stops forcing more
    than ~2x padding slots for a small bucket (tiny boxes can request
    P=512 lanes' worth of packing; 2 real items would pad to 512).
    Archive bytes are layout-independent, so the cap is purely a
    compute/VMEM economy.

    With ``z`` given, never cap below a full 128-lane row (P*z >= 128):
    narrower lane shapes are kernel classes no hardware run has
    validated (Mosaic enforces tiling rules interpret mode does not),
    so the floor keeps production on proven shapes at the cost of a
    little extra padding for very small buckets."""
    floor = 1
    if z and z > 0:
        floor = max(1, -(-128 // z))
    while pack > floor and pack // 2 >= floor and pack >= 2 * max(1, n_items):
        pack //= 2
    return max(1, pack)


def dense_batch_nbytes(n_items: int, dims, pack: int = 1,
                       pad_multiple: int = 1) -> int:
    """Bytes of the padded dense array :func:`empty_batch` would allocate
    — for transport-cost decisions without allocating it."""
    x, y, z = dims
    pack = cap_pack(pack, n_items, z)
    quantum = pack * pad_multiple
    n_pad = pad_to_multiple(n_items, quantum) if quantum > 1 else n_items
    return n_pad * x * y * z * 4


class BufferArena:
    """Recycles decompress-side batch buffers across shape buckets and
    timesteps.

    A fresh ``np.zeros`` costs one page fault per 4 KiB on first write;
    measured on the build host that roughly HALVES the native unpack rate
    (host_codec.json cold vs warm rows).  Decompression regenerates the
    same shape buckets every timestep, so recycling turns every unpack
    after the first timestep into a warm-buffer run.

    Contract: ``release(arr)`` only after the device step that read the
    buffer has completed (the engine fetches results via ``np.asarray``
    before returning, so releasing after the pipeline's device stage is
    safe even with the prefetch worker unpacking the next bucket
    concurrently — that one acquires a different buffer by construction).

    Retention is generation-bounded: the pipeline calls
    :meth:`new_generation` at every timestep boundary, and a buffer idle
    for one full generation is dropped — an AMR dataset that REGRIDS
    (box shapes changing across timesteps) therefore cannot accumulate
    dead shapes without bound (round-4 review finding); retained bytes
    are bounded by the last two timesteps' buffers, the same bound
    ``prefetch=1`` already documents for peak RSS.
    """

    def __init__(self, keep_generations: int = 1):
        self._free: dict = {}          # shape -> [(gen_released, arr), ...]
        self._gen = 0
        self._keep = int(keep_generations)
        # acquire/release run from host-stage worker threads concurrently
        # with the main thread; new_generation rebuilds the free lists.
        # The lock makes all three safe regardless of caller thread — the
        # pipelines happen to call new_generation only after the per-
        # timestep pool has drained, but that contract was implicit and
        # one future caller away from double-handing a buffer (round-4
        # advisor finding).
        self._lock = threading.Lock()

    def acquire(self, shape) -> "np.ndarray | None":
        with self._lock:
            lst = self._free.get(tuple(shape))
            return lst.pop()[1] if lst else None

    def release(self, arr) -> None:
        if arr is not None and isinstance(arr, np.ndarray) \
                and arr.dtype == np.float32:
            with self._lock:
                self._free.setdefault(arr.shape, []).append((self._gen, arr))

    def new_generation(self) -> None:
        """Timestep boundary: evict buffers released more than
        ``keep_generations`` generations ago (i.e. never reacquired for a
        full timestep — the shapes a regrid left behind).  Thread-safe
        (guarded by the same lock as acquire/release), though buffers a
        worker still holds are naturally outside the arena's view."""
        with self._lock:
            self._gen += 1
            cut = self._gen - self._keep
            for shape in list(self._free):
                kept = [e for e in self._free[shape] if e[0] >= cut]
                if kept:
                    self._free[shape] = kept
                else:
                    del self._free[shape]


def empty_batch(items, dims, pack: int = 1, pad_multiple: int = 1,
                layout: str = "halves", scales: int = 1,
                arena: "BufferArena | None" = None) -> ShapeBatch:
    """Zero-filled ShapeBatch for ``items`` of one shape (decompress side).

    With ``arena``, a recycled buffer may be returned instead: only the
    padding slots (which ``unpack_into`` never rewrites — every real item's
    full footprint is) are re-zeroed."""
    x, y, z = dims
    n = len(items)
    pack = cap_pack(pack, n, z)
    quantum = pack * pad_multiple
    n_pad = pad_to_multiple(n, quantum) if quantum > 1 else n
    arr_shape = ((n_pad, x, y, z) if pack == 1
                 else (n_pad // pack, x, y, pack * z))
    data = arena.acquire(arr_shape) if arena is not None else None
    if data is None:
        data = np.zeros(arr_shape, dtype=np.float32)
    elif pack == 1:
        data[n:] = 0.0
    else:
        for i in range(n, n_pad):
            mrow, p = divmod(i, pack)
            data[mrow, :, :, p * z:(p + 1) * z] = 0.0
    return ShapeBatch(shape=tuple(dims), data=data, items=list(items),
                      n_valid=n, pack=pack, layout=layout, scales=scales)


def plan_batches(entries, pad_multiple: int = 1, max_batch_bytes: int = 1 << 30,
                 pack_fn=None, pad_fn=None):
    """Group ``entries`` = iterable of (WorkItem, array[X,Y,Z] f32) into
    :class:`ShapeBatch` es.

    ``pack_fn(shape) -> P`` selects the lane-pack factor per shape (e.g.
    ``kernels.haar_pallas.lane_pack_factor`` when the engine runs the fused
    TPU kernels); omitted/1 keeps the plain layout.  Batches are split so
    none exceeds ``max_batch_bytes``; N pads to a multiple of
    ``P * pad_multiple`` so the packed leading axis shards evenly over the
    mesh.  ``pad_fn(shape) -> int`` overrides ``pad_multiple`` per shape
    (``engine.pad_multiple_for``: giant shapes shard within the box, so
    their batches must not pad phantom giant boxes onto the leading axis).
    """
    buckets = {}
    for item, arr in entries:
        shape = tuple(arr.shape)
        buckets.setdefault(shape, []).append((item, arr))

    batches = []
    for shape in sorted(buckets, key=lambda s: (-int(np.prod(s)), s)):
        pairs = buckets[shape]
        pad_m = int(pad_fn(shape)) if pad_fn is not None else pad_multiple
        pack = int(pack_fn(shape)) if pack_fn is not None else 1
        pack = cap_pack(pack, len(pairs), shape[-1])
        quantum = pack * pad_m
        per_item = int(np.prod(shape)) * 4
        chunk = max(quantum, (max_batch_bytes // max(per_item, 1)) or 1)
        # round DOWN to the quantum so a chunk never exceeds
        # max_batch_bytes by up to quantum-1 items (the unavoidable
        # single-quantum minimum is the only sanctioned overshoot)
        chunk = max(quantum, chunk - chunk % quantum)
        x, y, z = shape
        for start in range(0, len(pairs), chunk):
            part = pairs[start : start + chunk]
            n = len(part)
            n_pad = pad_to_multiple(n, quantum) if quantum > 1 else n
            if pack == 1:
                data = np.zeros((n_pad,) + shape, dtype=np.float32)
                for i, (_item, arr) in enumerate(part):
                    data[i] = arr
            else:
                data = np.zeros((n_pad // pack, x, y, pack * z),
                                dtype=np.float32)
                for i, (_item, arr) in enumerate(part):
                    m, p = divmod(i, pack)
                    data[m, :, :, p * z : (p + 1) * z] = arr
            batches.append(ShapeBatch(shape=shape, data=data,
                                      items=[it for it, _ in part],
                                      n_valid=n, pack=pack))
    return batches
