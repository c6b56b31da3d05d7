"""The device codec engine on PyTorch: compress/decompress steps over
shape-bucketed batches, and the parallel host packer.

Counterpart of ``wavelet_tpu.runtime.engine`` for one device and dense
transfer: box thresholds and the global-threshold histogram pass, on
single-scale transforms or ``scales``-deep pyramids.  Coefficients use the
``halves`` layout (the reference's order, the pyramid in logical order),
one box per batch row (``pack=1``): on the card one thread per 2x2x2 cell
writes that layout with coalesced stores, so the TPU's interleaved layout
and lane packing buy nothing here.  Branches outside the port raise
``NotImplementedError``; none falls back to another path.

Kernels per shape, with ``eff = eff_scales(shape)``: box mode runs
``haar_cuda.fused_forward`` at eff = 1 and ``pyramid_cuda.pyramid_forward``
deeper; the global pass runs ``pyramid_cuda.forward_hist`` at every eff;
decompression runs ``haar_cuda.fused_inverse`` or
``pyramid_cuda.pyramid_inverse``.

``resolve_signed_absmax`` and ``HostPacker`` are jax-free copies of the JAX
package's (the originals live in a module that imports jax at the top).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os

import numpy as np
import torch

from wavelet_tpu import native
from wavelet_tpu.core import rle
from wavelet_tpu.io import archive, bundle
from wavelet_tpu.runtime.batching import ShapeBatch
from wavelet_tpu_torch.core import threshold
from wavelet_tpu_torch.kernels import haar_cuda, pyramid_cuda

__all__ = ["CodecEngine", "HostPacker", "resolve_signed_absmax",
           "resolve_device"]


def resolve_device(device) -> torch.device:
    """``"cuda"`` / ``"cpu"`` / a ``torch.device`` -> a usable device.
    ``cuda`` without a CUDA runtime raises: the port never runs a
    CUDA-requested job on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device=cuda requested but "
                               "torch.cuda.is_available() is false")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda|cpu)")
    return dev


def resolve_signed_absmax(maxv: np.ndarray, minv: np.ndarray,
                          row_getter=None) -> np.ndarray:
    """Signed largest-|.| value from per-box (max, min) pairs.

    The signed extremum is whichever has the larger magnitude.  The only
    ambiguous case is an exact tie ``min == -max != 0``, where the reference
    picks whichever occurs *first* in flatten order (compressor.cpp:212-215);
    those rare boxes are resolved from ``row_getter(i)``, which must return
    item i's flat coefficients on the host.
    """
    signed = np.where(np.abs(maxv) >= np.abs(minv), maxv, minv)
    tie = (minv == -maxv) & (maxv != 0)
    if tie.any() and row_getter is not None:
        for i in np.flatnonzero(tie):
            row = np.asarray(row_getter(int(i)))
            signed[i] = row[np.argmax(np.abs(row))]
    return signed


class CodecEngine:
    """Runs the device side of the codec over ShapeBatches on ``device``.

    On a CUDA device the transforms are the hand-written kernels of
    ``kernels/haar_cuda.py`` and ``kernels/pyramid_cuda.py``; on the CPU,
    their plain PyTorch versions — bitwise the same results."""

    def __init__(self, device="cuda", scales: int = 1):
        self.device = resolve_device(device)
        self.scales = int(scales)

    def eff_scales(self, dims) -> int:
        """Deepest pyramid this box shape supports, capped at the requested
        ``scales``: every dim must divide by ``2**eff``.  AMR runs mix box
        sizes (an (8, 4, 2) box takes one scale); decompression derives the
        same value from dims and the archive's ``scales``."""
        s = self.scales
        while s > 1 and any(int(d) % (1 << s) for d in dims):
            s -= 1
        return s

    def coeff_layout(self, dims) -> str:
        return "halves"

    def pack_factor(self, dims) -> int:
        return 1

    def pad_multiple_for(self, dims) -> int:
        return 1

    def _put(self, data: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(
            self.device)

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    def _forward(self, data: np.ndarray):
        """-> (coeffs [N, X, Y, Z] on the host, signed absmax [N])."""
        eff = self.eff_scales(data.shape[1:])
        if eff > 1:
            c, maxv, minv = pyramid_cuda.pyramid_forward(self._put(data), eff)
        else:
            c, maxv, minv = haar_cuda.fused_forward(self._put(data))
        coeffs = self._host(c)
        flat = coeffs.reshape(coeffs.shape[0], -1)
        signed = resolve_signed_absmax(self._host(maxv), self._host(minv),
                                       row_getter=flat.__getitem__)
        return coeffs, signed

    def forward_signed_batch(self, data: np.ndarray):
        """-> (coeffs f32 [N, XYZ], signed absmax f32 [N])."""
        coeffs, signed = self._forward(data)
        return coeffs.reshape(coeffs.shape[0], -1), signed

    def compress_batch_raw(self, data: np.ndarray, keep: float):
        """-> (coeffs f32 [N, XYZ], t32 f32 [N]): transform + exact per-item
        thresholds; the host packer applies ``|c| > t32`` during RLE."""
        flat, signed = self.forward_signed_batch(data)
        return flat, threshold.exact_threshold32(signed, keep)

    def compress_shapebatch(self, batch: ShapeBatch, keep: float):
        """-> (coefficient ShapeBatch of the same geometry, t32 f32 per
        item incl. padding slots)."""
        self._check_batch(batch)
        coeffs, signed = self._forward(batch.data)
        return (dataclasses.replace(batch, data=coeffs),
                threshold.exact_threshold32(signed, keep))

    def _forward_hist(self, data: np.ndarray):
        """-> (coeffs [N, X, Y, Z] on the device, int64 histogram of the
        whole batch on the host)."""
        eff = max(1, self.eff_scales(data.shape[1:]))
        c, hist = pyramid_cuda.forward_hist(self._put(data), eff)
        return c, self._host(hist)

    def forward_hist_shapebatch(self, batch: ShapeBatch,
                                fetch_coeffs: bool = True):
        """Global-threshold pass: -> (coefficient ShapeBatch, int64
        histogram of the real items).  ``fetch_coeffs=False`` returns
        ``(None, hist)`` and moves no coefficient to the host."""
        self._check_batch(batch)
        c, hist = self._forward_hist(batch.data)
        # padding slots are zero boxes: take their coefficients out of the
        # zero bin so the quantile counts real coefficients only
        n_pad = batch.data.shape[0] - batch.n_valid
        hist[0] -= n_pad * int(np.prod(batch.shape))
        if not fetch_coeffs:
            return None, hist
        return dataclasses.replace(batch, data=self._host(c)), hist

    def forward_hist_batch(self, data: np.ndarray, n_pad_rows: int = 0):
        """-> (flat [N, XYZ], int64 histogram); ``n_pad_rows`` all-zero
        padding rows are taken out of the zero bin."""
        c, hist = self._forward_hist(np.asarray(data, np.float32))
        flat = self._host(c).reshape(c.shape[0], -1)
        hist[0] -= n_pad_rows * flat.shape[1]
        return flat, hist

    def _inverse(self, blocks: np.ndarray) -> np.ndarray:
        eff = self.eff_scales(blocks.shape[1:])
        if eff > 1:
            out = pyramid_cuda.pyramid_inverse(self._put(blocks), eff)
        else:
            out = haar_cuda.fused_inverse(self._put(blocks))
        return self._host(out)

    def decompress_shapebatch(self, coeff_batch: ShapeBatch) -> ShapeBatch:
        """Coefficients -> reconstructed boxes, same geometry."""
        self._check_batch(coeff_batch)
        return dataclasses.replace(coeff_batch,
                                   data=self._inverse(coeff_batch.data))

    def decompress_batch(self, flat: np.ndarray, dims) -> np.ndarray:
        """flat f32 [N, X*Y*Z] -> boxes f32 [N, X, Y, Z]."""
        dims = tuple(int(d) for d in dims)
        return self._inverse(np.asarray(flat, np.float32).reshape(
            (-1,) + dims))

    def _check_batch(self, batch: ShapeBatch) -> None:
        # spatial batches carry scales=1, coefficient batches eff_scales
        if (batch.pack != 1 or batch.layout != "halves"
                or batch.scales not in (1, self.eff_scales(batch.shape))):
            raise NotImplementedError(
                f"batch geometry pack={batch.pack} layout={batch.layout!r} "
                f"scales={batch.scales} is not ported (pack=1, halves, "
                "scales=1 or eff_scales(shape) only)")


def _atomic_write(path: str, blob: bytes) -> None:
    """Temp-name + rename so a crash mid-write never leaves a truncated
    output that a resumed run (resume=1) would skip as complete."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


class HostPacker:
    """Parallel host-side pack/unpack + file I/O for ``halves`` batches.

    Two backends with identical byte output: the native C++ codec
    (native/wtc_codec.cpp) on its worker pool, or NumPy RLE + stdlib
    ``lzma`` on a thread pool when the shared library is unavailable.
    Two archive layouts with identical member bytes: ``files`` (one
    ``.xz`` per (t, lev, comp, box), reference-compatible) and ``bundle``
    (one container per timestep; callers must :meth:`close_bundles`).
    """

    def __init__(self, workers: int | None = None,
                 use_native: bool | None = None, payload: str = "f32",
                 codec: str = "xz", xz_preset: int = 6,
                 archive_format: str = "files", xz_delta: int = 0):
        self.workers = workers or min(32, (os.cpu_count() or 4))
        if payload not in ("f32", "q16"):
            raise ValueError(f"unknown payload format {payload!r}")
        if codec not in ("xz", "raw"):
            raise ValueError(f"unknown payload codec {codec!r}")
        if archive_format not in ("files", "bundle"):
            raise ValueError(f"unknown archive format {archive_format!r}")
        self.payload = payload
        self.codec = codec
        self.xz_preset = archive.pack_preset(xz_preset, xz_delta)
        self.archive_format = archive_format
        self._writers = {}          # (dir, t) -> BundleWriter
        self._bundle_sets = {}      # dir -> BundleSet (read side, lazy)
        if use_native is None:
            use_native = native.available()
        self.use_native = use_native and native.available()

    def _paths(self, dir_, items):
        return [os.path.join(dir_, archive.payload_filename(
            it.t, it.level, it.comp_idx, it.box)) for it in items]

    # ---- bundle plumbing ----

    def _writer(self, dir_: str, t: int) -> bundle.BundleWriter:
        key = (dir_, int(t))
        w = self._writers.get(key)
        if w is None:
            proc = 0     # one process: multi-process runs are not ported
            gen = 0
            while True:
                path = os.path.join(dir_, bundle.bundle_name(t, proc, gen))
                if not os.path.exists(path):
                    break
                # resume: finished bundles are immutable — append the
                # remaining items as a new generation
                gen += 1
            w = self._writers[key] = bundle.BundleWriter(path)
        return w

    def _append_members(self, dir_: str, items, blobs) -> int:
        """Append (item, blob) pairs in item order (deterministic bytes)."""
        total = 0
        for it, blob in zip(items, blobs):
            total += self._writer(dir_, it.t).add(
                it.t, it.level, it.comp_idx, it.box, blob)
        return total

    def close_bundles(self, t: int | None = None) -> int:
        """Finalize open bundles (all, or only timestep ``t``'s); returns
        the container bytes written."""
        total = 0
        for key in list(self._writers):
            if t is None or key[1] == int(t):
                total += self._writers.pop(key).close()
        return total

    def _bundle_set(self, dir_: str) -> bundle.BundleSet:
        bs = self._bundle_sets.get(dir_)
        if bs is None:
            bs = self._bundle_sets[dir_] = bundle.BundleSet(dir_)
        return bs

    @staticmethod
    def _geometry(batch: ShapeBatch):
        """(rows, row_len, row_stride) of one item inside batch.data."""
        if batch.pack != 1 or batch.layout != "halves":
            raise NotImplementedError(
                "the port's packer walks pack=1 halves batches only")
        n = int(np.prod(batch.shape))
        return 1, n, n

    def pack(self, out_dir: str, coeff_batch: ShapeBatch,
             t32: np.ndarray, subset=None) -> int:
        """Threshold+RLE+xz+write items of a coefficient ShapeBatch
        (padding slots ignored; ``subset`` restricts to those item
        indices).  Returns total compressed bytes."""
        items = coeff_batch.items
        rows, row_len, row_stride = self._geometry(coeff_batch)
        sel = list(range(len(items))) if subset is None else list(subset)
        bundled = self.archive_format == "bundle"
        if self.use_native:
            if not sel:
                return 0
            offsets = coeff_batch.item_offsets()
            t32_sel = np.asarray(t32)[sel]
            if bundled:
                blobs = native.encode_strided(
                    coeff_batch.data, t32_sel, coeff_batch.shape, rows,
                    row_len, row_stride, offsets[sel], self.workers,
                    payload=self.payload, codec=self.codec,
                    preset=self.xz_preset)
                return self._append_members(
                    out_dir, [items[i] for i in sel], blobs)
            return native.pack_strided(
                coeff_batch.data, t32_sel, coeff_batch.shape,
                self._paths(out_dir, [items[i] for i in sel]),
                rows, row_len, row_stride, offsets[sel], self.workers,
                payload=self.payload, codec=self.codec,
                preset=self.xz_preset)

        serialize = (archive.serialize_payload_q16 if self.payload == "q16"
                     else archive.serialize_payload)
        paths = None if bundled else self._paths(out_dir, items)

        def one(i):
            flat = np.ascontiguousarray(coeff_batch.item_view(i)).reshape(-1)
            mask = np.abs(flat) > t32[i]
            runs, vals = rle.rle_encode_mask(mask, flat)
            blob = archive.encode_blob(
                serialize(coeff_batch.shape, runs, vals),
                self.codec, self.xz_preset)
            if bundled:
                return blob
            _atomic_write(paths[i], blob)
            return len(blob)

        with cf.ThreadPoolExecutor(self.workers) as ex:
            results = list(ex.map(one, sel))
        if bundled:
            return self._append_members(
                out_dir, [items[i] for i in sel], results)
        return sum(results)

    def unpack_into(self, in_dir: str, batch: ShapeBatch) -> None:
        """Read + xz-decode + RLE-scatter every item into ``batch.data``."""
        dims = batch.shape
        rows, row_len, row_stride = self._geometry(batch)
        bundled = self.archive_format == "bundle"
        if bundled:
            bs = self._bundle_set(in_dir)
            blobs = [bs.blob(it.t, it.level, it.comp_idx, it.box)
                     for it in batch.items]
        else:
            paths = self._paths(in_dir, batch.items)
        if self.use_native:
            if bundled:
                shapes = native.unpack_strided_mem(
                    blobs, batch.data, rows, row_len, row_stride,
                    batch.item_offsets(), self.workers,
                    payload=self.payload, codec=self.codec)
            else:
                shapes = native.unpack_strided(
                    paths, batch.data, rows, row_len, row_stride,
                    batch.item_offsets(), self.workers,
                    payload=self.payload, codec=self.codec)
            if not np.all(shapes == np.asarray(dims, np.int32)):
                raise ValueError(
                    f"payload shapes disagree with dimensions.raw {dims}")
            return

        deserialize = (archive.deserialize_payload_q16
                       if self.payload == "q16"
                       else archive.deserialize_payload)

        def one(i):
            if bundled:
                payload = archive.decode_blob(blobs[i], self.codec)
            else:
                with open(paths[i], "rb") as f:
                    payload = archive.decode_blob(f.read(), self.codec)
            shape, total, runs, vals = deserialize(payload)
            if tuple(shape) != tuple(dims):
                raise ValueError(
                    f"payload shape {shape} disagrees with dimensions.raw "
                    f"{dims}")
            batch.item_write(i, rle.rle_decode(
                runs, vals, total).reshape(dims))

        with cf.ThreadPoolExecutor(self.workers) as ex:
            list(ex.map(one, range(len(batch.items))))
