"""The device codec engine on PyTorch: compress/decompress steps over
shape-bucketed batches, and the parallel host packer.

Counterpart of ``wavelet_tpu.runtime.engine``: box thresholds and the
global-threshold histogram pass, on single-scale transforms or
``scales``-deep pyramids, with dense or sparse transfer, the low-band
preview, on one device or over a mesh (``runtime/mesh``).  Coefficients
use the ``halves`` layout (the reference's order, the pyramid in logical
order).  Branches outside the port raise ``NotImplementedError``; none
falls back to another path.

With ``mesh=`` every batch whose row count the mesh divides is split into
``mesh.size`` contiguous row chunks, each run by its kernel on its own
mesh entry (the JAX engine's ``shard_map`` over the ``data`` axis); other
batches run whole on the first entry, as the JAX package runs them
unsharded.  A giant box (``giant_ok``: at least ``giant_box_bytes``, and a
giant mesh of two or more entries) is instead split along X over the
giant mesh (``runtime/distributed``): with ``giant_mesh_mode="global"``
in a multi-process run, every process's entries
(``runtime/mesh.global_mesh``: each process runs its own slabs and the
slab pyramids are gathered over gloo); else ``mesh``; else, in a
multi-process run, this process's share of its host's cards.  Results
come back in item order either way, so archives do not depend on the
mesh.

Two kernel routes, the JAX package's A/B switch ``WAVELET_TPU_LAYOUT``
(or ``CodecEngine(layout=)``):

- ``auto`` / ``interleaved`` (the default): one box per batch row
  (``pack=1``).  On the card one thread per 2x2x2 cell writes the halves
  layout with coalesced stores, so the TPU's in-place interleaved layout
  has no counterpart here.  With ``eff = eff_scales(shape)``, box mode runs
  ``haar_cuda.fused_forward`` at eff = 1 and
  ``pyramid_cuda.pyramid_forward`` deeper; the global pass runs
  ``pyramid_cuda.forward_hist`` at every eff; decompression runs
  ``haar_cuda.fused_inverse`` or ``pyramid_cuda.pyramid_inverse``.
- ``halves``: the JAX package's halves route.  At ``scales=1`` a box of at
  most 4 MiB whose even Z divides 128 is lane-packed P = 128/Z boxes per
  row (``pack_factor``) and runs ``packed_cuda.packed_forward`` /
  ``packed_forward_hist`` / ``packed_inverse``; every other shape keeps
  the default route's kernels.  Archives are byte-identical either way.
  Measured on an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``,
  PERF.md): on the same bytes, ``packed_forward`` at [80, 64, 64,
  128] (P = 2) takes 0.132 ms against K1's 0.151 ms at [160, 64, 64, 64]
  and ``packed_inverse`` 0.122 ms like K2; at P = 64 (8x4x2 boxes) the
  packed kernels take 0.149 / 0.120 ms against K1/K2's 2.51 / 0.229 ms.
  End to end the host's xz pack sets the wall on either route, so the
  default stays ``pack=1`` until a benchmark cell shows a gain.

Sparse transfer (``transfer=sparse``, or ``auto`` on a slow link) compacts
the thresholded coefficients on the card with ``compact_cuda.compact``
(item-major logical rows, unpacked first on the halves route) and ships
only the kept (index, value) pairs; on decompress the pairs are scattered
into zeroed rows on the card before the one-box-per-row inverse kernel.

``SparseCoeffs``, ``resolve_signed_absmax`` and ``HostPacker`` are jax-free
copies of the JAX package's (the originals live in a module that imports
jax at the top).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import logging
import os
import time

import numpy as np
import torch

from wavelet_tpu_torch.core import haar, rle, threshold
from wavelet_tpu_torch.core.threshold import resolve_signed_absmax
from wavelet_tpu_torch.io import archive, bundle
from wavelet_tpu_torch.runtime import distributed
from wavelet_tpu_torch.runtime import mesh as mesh_lib
from wavelet_tpu_torch.runtime.batching import ShapeBatch
from wavelet_tpu_torch.runtime.debug import span
from wavelet_tpu_torch.runtime.mesh import resolve_device
from wavelet_tpu_torch.runtime.packstream import PackStream
from wavelet_tpu_torch.kernels import (compact_cuda, haar_cuda,
                                       packed_cuda, pyramid_cuda)

log = logging.getLogger("wavelet_tpu_torch")

__all__ = ["CodecEngine", "HostPacker", "SparseCoeffs",
           "resolve_signed_absmax", "resolve_device"]


@dataclasses.dataclass
class SparseCoeffs:
    """Device-sparsified coefficients: per item, the kept (index, value)
    pairs in flatten order, capacity-bounded.  The JAX package's copy also
    maps a permuted (interleaved) layout back to logical order; the port's
    halves layout is logical, so that map does not exist here."""

    shape: tuple
    items: list
    counts: np.ndarray        # int32 [N_pad]
    idxs: np.ndarray          # int32 [N_pad, cap]
    vals: np.ndarray          # f32  [N_pad, cap]
    cap: int
    _flat_dev: object = None  # dense [N, m] tensor (or _ChunkRows) for
                              # the overflow fallback
    _flat_np: object = None   # bulk dense fallback, fetched lazily once

    def transfer_bytes(self) -> int:
        """Actual device->host traffic this sparsification costs: the pair
        buffers PLUS the dense rows the overflow fallback fetches (a bulk
        fallback pulls the whole flat array once) — the honest number for
        the ``device_to_host_bytes`` stat."""
        n = len(self.items)
        total = self.counts.nbytes + self.idxs.nbytes + self.vals.nbytes
        n_over = int(np.sum(self.counts[:n] > self.cap))
        if not n_over:
            return total
        m = int(np.prod(self.shape))
        if n_over > max(2, n // 10) and self._flat_dev is not None:
            return total + int(np.prod(self._flat_dev.shape)) * 4
        return total + n_over * m * 4

    def item_pairs(self, i: int, t32_i: float):
        """(indices, values) of item i's kept coefficients."""
        k = int(self.counts[i])
        if k <= self.cap:
            return self.idxs[i, :k], self.vals[i, :k]
        # overflow: if it's widespread, one bulk fetch beats per-item round
        # trips (each costs a full host-link latency)
        if self._flat_np is None:
            n_over = int(np.sum(self.counts[: len(self.items)] > self.cap))
            if n_over > max(2, len(self.items) // 10):
                self._flat_np = self._flat_dev.cpu().numpy()
        if self._flat_np is not None:
            row = self._flat_np[i]
        else:
            row = self._flat_dev[i].cpu().numpy()
        idx = np.flatnonzero(np.abs(row) > t32_i)
        return idx.astype(np.int32), row[idx]


class _ChunkRows:
    """Row chunks ``[n_k, m]`` on their mesh entries, read as one
    ``[N, m]`` array: the dense fallback rows of a mesh batch's
    :class:`SparseCoeffs` (``shape``, ``[i]`` and ``cpu()`` as a tensor)."""

    def __init__(self, parts):
        self.parts = parts
        self.shape = (sum(int(p.shape[0]) for p in parts),
                      int(parts[0].shape[1]))

    def __getitem__(self, i: int) -> torch.Tensor:
        for p in self.parts:
            if i < p.shape[0]:
                return p[i]
            i -= int(p.shape[0])
        raise IndexError(i)

    def cpu(self) -> torch.Tensor:
        return torch.cat([p.cpu() for p in self.parts])


class CodecEngine:
    """Runs the device side of the codec over ShapeBatches on ``device``,
    or over ``mesh`` (a :class:`~wavelet_tpu_torch.runtime.mesh.
    DeviceMesh` of ``device``'s type; its first entry then stands for
    ``device``).

    On a CUDA device the transforms and the compaction are the
    hand-written kernels of ``kernels/haar_cuda.py``,
    ``kernels/pyramid_cuda.py``, ``kernels/packed_cuda.py`` and
    ``kernels/compact_cuda.py``; on the CPU, their plain PyTorch versions
    — bitwise the same results.  ``layout=None`` reads
    ``WAVELET_TPU_LAYOUT`` (``auto`` | ``interleaved`` | ``halves``).
    ``giant_box_bytes=None`` reads ``WAVELET_TPU_GIANTBOX`` (default 1
    GiB; CLI ``giantbox=``).  ``giant_mesh_mode="global"`` (CLI
    ``giantmesh=global``) splits giant boxes over every process's entries;
    in a multi-process run every process then builds its engine at the
    same point (the global mesh is counted over gloo) and takes part in
    every giant box's transform.

    ``stats`` (a dict, by default the engine's own) receives the seconds
    of the device step's parts as the calling thread sees them:
    ``h2d_seconds`` (pageable host-to-device copies), ``launch_seconds``
    (the kernel wrappers' calls), ``d2h_seconds`` (device-to-host copies,
    which wait for the kernels), ``threshold_seconds`` (the host's
    ``resolve_signed_absmax`` and ``exact_threshold32``) and
    ``free_seconds`` (dropping the step's device tensors), each a
    :func:`~wavelet_tpu_torch.runtime.debug.span` (``engine.h2d``,
    ``engine.launch``, ``engine.d2h``, ``engine.threshold``,
    ``engine.free``)."""

    # one box must fit the JAX halves kernels' VMEM block: the bound of the
    # halves route's packed shapes, kept so both packages pack alike
    _PALLAS_MAX_BLOCK_BYTES = 4 << 20

    def __init__(self, device="cuda", scales: int = 1,
                 layout: str | None = None, mesh=None,
                 giant_box_bytes: int | None = None,
                 giant_mesh_mode: str = "local", stats: dict | None = None):
        self.device = resolve_device(device)
        self.stats = {} if stats is None else stats
        if mesh is not None:
            if any(d.type != self.device.type for d in mesh.devices):
                raise ValueError(f"device={device} but the mesh holds "
                                 f"{[str(d) for d in mesh.devices]}")
            self.device = mesh.devices[0]
        self.mesh = mesh
        self.scales = int(scales)
        self._sparse_cap_hint: dict = {}   # shape -> adaptive cap fraction
        if layout is None:
            layout = os.environ.get("WAVELET_TPU_LAYOUT", "auto")
        if layout not in ("auto", "interleaved", "halves"):
            raise ValueError(f"unknown kernel layout {layout!r}")
        self.layout = layout
        if giant_box_bytes is None:
            giant_box_bytes = int(os.environ.get("WAVELET_TPU_GIANTBOX",
                                                 1 << 30))
        self.giant_box_bytes = int(giant_box_bytes)
        if giant_mesh_mode not in ("local", "global"):
            raise ValueError(f"unknown giant mesh mode {giant_mesh_mode!r} "
                             "(local|global)")
        self._global_giant_mesh = None
        self._local_giant_mesh = None     # False: looked, none
        if giant_mesh_mode == "global" and mesh_lib.process_count() > 1:
            self._global_giant_mesh = mesh_lib.global_mesh(
                mesh if mesh is not None
                else mesh_lib.DeviceMesh([self.device]))
            log.info("giantmesh=global: giant boxes split over all %d mesh "
                     "entries across %d processes; every process takes part "
                     "in each giant box's transform and gloo gather",
                     self._global_giant_mesh.size,
                     mesh_lib.process_count())

    def _giant_mesh(self):
        """The mesh giant boxes split over, or None: the global mesh
        (``giant_mesh_mode="global"`` in a multi-process run); else
        ``mesh`` if it has two or more entries; else, in a multi-process
        run on CUDA, this process's share of its host's cards (the JAX
        package's ``jax.local_devices()``): ``local_cards(K)`` with K =
        cards on the host // processes on the host, when K >= 2."""
        if self._global_giant_mesh is not None:
            return self._global_giant_mesh
        if self.mesh is not None and self.mesh.size > 1:
            return self.mesh
        if self._local_giant_mesh is None:
            self._local_giant_mesh = False
            if mesh_lib.process_count() > 1 and self.device.type == "cuda":
                k = (torch.cuda.device_count()
                     // mesh_lib.local_process_count())
                if k > 1:
                    self._local_giant_mesh = mesh_lib.data_mesh(
                        mesh_lib.local_cards(k))
                    log.info("Giant boxes split over this process's cards "
                             "%s (no devices=: %d cards per process on this "
                             "host)", [str(d) for d in
                                       self._local_giant_mesh.devices], k)
        return self._local_giant_mesh or None

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

    def _halves_ok(self, dims) -> bool:
        """Whether boxes of this shape take the halves route's packed
        kernels (the JAX package's ``_halves_ok`` with ``use_pallas``)."""
        return (self.layout == "halves" and self.scales == 1
                and int(np.prod(dims)) * 4 <= self._PALLAS_MAX_BLOCK_BYTES)

    def giant_ok(self, dims) -> bool:
        """Whether boxes of this shape are split along X over the giant
        mesh (``runtime/distributed``): a giant mesh (:meth:`_giant_mesh`),
        a box of at least ``giant_box_bytes``, every dim divisible by
        ``2**max(1, eff)`` and X by ``size * 2**eff``, so each slab holds
        whole pairs at every scale (the JAX package's gate)."""
        m = self._giant_mesh()
        if m is None:
            return False
        if int(np.prod(dims)) * 4 < self.giant_box_bytes:
            return False
        eff = self.eff_scales(dims)
        q = 1 << max(1, eff)
        return (all(int(d) % q == 0 for d in dims)
                and int(dims[0]) % (m.size * (1 << eff)) == 0)

    def pack_factor(self, dims) -> int:
        """Boxes per batch row (``batching.plan_batches``' ``pack_fn``);
        giant boxes are split within the box, one per row."""
        if self._halves_ok(dims) and not self.giant_ok(dims):
            return packed_cuda.lane_pack_factor(dims)
        return 1

    def pad_multiple_for(self, dims) -> int:
        """Batch padding quantum (``plan_batches``' ``pad_fn``): the mesh
        size, so every row chunk is whole; 1 for giant shapes, which must
        not gain phantom giant boxes."""
        if self.mesh is None or self.giant_ok(dims):
            return 1
        return self.mesh.size

    # transfer=auto breakevens, one per link direction.  At a kept
    # fraction f the sparse stream is about 2f of the dense bytes (8 B
    # pairs vs 4 B dense), so per input byte dense costs 1/B link seconds
    # vs sparse 1/S + 2f/B for a device stage of S GB/s: sparse wins iff
    # B < S * (1 - 2f), about B < S at a few percent kept.
    # - compress fetches pairs d2h behind the compact stage
    #   (compact_cuda.compact, the single-pass kernel): S = 1448 GB/s of
    #   coefficients;
    # - decompress ships pairs h2d in front of the scatter + inverse
    #   stage (scatter_rows, then the one-scale inverse kernel): S = 230
    #   GB/s.
    # Both measured by chip_smoke.py on its dataset's [160, 64, 64, 64]
    # one-scale coefficient rows (keep=0.999, 16.6% kept) on an NVIDIA
    # H100 80GB HBM3 at a 700.00 W power limit (PERF.md).  Other cards
    # differ, so both are env-overridable under the JAX package's names:
    # WAVELET_TPU_SPARSE_BELOW_{D2H,H2D}=GB/s.
    _AUTO_SPARSE_BELOW_GBPS = {
        "d2h": float(os.environ.get("WAVELET_TPU_SPARSE_BELOW_D2H",
                                    1448.0)),
        "h2d": float(os.environ.get("WAVELET_TPU_SPARSE_BELOW_H2D", 230.0)),
    }
    # links drift, so the probe re-runs on a cadence instead of pinning
    # the process to its startup measurement
    _LINK_REPROBE_S = float(os.environ.get("WAVELET_TPU_LINK_REPROBE_S",
                                           300.0))
    _measured_link_gbps: dict | None = None    # per-process, class-level
    _measured_link_at: float = 0.0

    @classmethod
    def _measure_link(cls) -> dict:
        """One link measurement of the current CUDA device, both
        directions, with the pageable copies the pipelines make
        (``torch.from_numpy(buf).to(dev)`` then ``.cpu()``): a warm-up
        transfer first (the first transfer of a process pays runtime
        init), then the median of 3 reps with FRESH random content each
        time.  The buffer GROWS until one transfer costs >= ~10x the
        measured per-dispatch latency, so fast links are not
        under-measured by fixed-size probes."""
        dev = torch.device("cuda", torch.cuda.current_device())
        rng = np.random.default_rng()        # OS entropy, never reused

        def put(a):
            t = torch.from_numpy(a).to(dev)
            torch.cuda.synchronize(dev)
            return t

        put(rng.standard_normal(1024).astype(np.float32)).cpu()
        t0 = time.perf_counter()
        put(rng.standard_normal(16).astype(np.float32)).cpu()
        dispatch_s = max(time.perf_counter() - t0, 1e-7)
        nbytes = 8 << 20
        while True:
            buf = rng.standard_normal(nbytes // 4).astype(np.float32)
            t0 = time.perf_counter()
            d = put(buf)
            h2d_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            d.cpu()
            d2h_s = time.perf_counter() - t0
            # dispatch_s timed a ROUND TRIP (two dispatches), so 5x of it
            # is the ~10x one-way dispatch margin the docstring promises
            if min(h2d_s, d2h_s) >= 5 * dispatch_s or nbytes >= 128 << 20:
                break
            nbytes *= 4
        d2h, h2d = [nbytes / 1e9 / max(d2h_s, 1e-9)], \
                   [nbytes / 1e9 / max(h2d_s, 1e-9)]
        for _rep in range(2):
            buf = rng.standard_normal(nbytes // 4).astype(np.float32)
            t0 = time.perf_counter()
            d = put(buf)
            h2d.append(nbytes / 1e9 / max(time.perf_counter() - t0, 1e-9))
            t0 = time.perf_counter()
            d.cpu()
            d2h.append(nbytes / 1e9 / max(time.perf_counter() - t0, 1e-9))
        return {"d2h": float(np.median(d2h)), "h2d": float(np.median(h2d)),
                "probe_bytes": nbytes}

    @classmethod
    def _link_gbps(cls) -> dict:
        """Cached link rates.  The FIRST measurement runs inline (pipelines
        decide transport before any device transfer is in flight); stale
        values are refreshed only via :meth:`reprobe_link_if_stale`, which
        the pipelines call at timestep boundaries — a probe that runs
        concurrently with the pipeline's own transfers would measure
        residual bandwidth and could flip the transport spuriously."""
        if cls._measured_link_gbps is None:
            cls._measured_link_gbps = cls._measure_link()
            cls._measured_link_at = time.monotonic()
            cur = cls._measured_link_gbps
            log.info("transfer=auto: measured link d2h %.3f / h2d %.3f "
                     "GB/s (probe %d MiB)", cur["d2h"], cur["h2d"],
                     cur["probe_bytes"] >> 20)
        return cls._measured_link_gbps

    @classmethod
    def reprobe_link_if_stale(cls) -> None:
        """Re-run the link probe when the cached measurement is older than
        _LINK_REPROBE_S (0 disables re-probing).  Call ONLY when the
        device link is quiescent — the pipelines call it at timestep
        boundaries on the main thread, where the previous step's device
        work has drained and the prefetch worker touches only the disk.
        A re-probe that flips any transport decision is logged."""
        # _measured_link_at == 0 with a value present means the value was
        # injected (tests / explicit pinning): never re-probe over it
        if (cls._measured_link_gbps is None or cls._LINK_REPROBE_S <= 0
                or cls._measured_link_at <= 0):
            return
        if (time.monotonic() - cls._measured_link_at
                <= cls._LINK_REPROBE_S):
            return
        prev = cls._measured_link_gbps
        cls._measured_link_gbps = cls._measure_link()
        cls._measured_link_at = time.monotonic()
        cur = cls._measured_link_gbps
        log.info("transfer=auto: re-measured link d2h %.3f / h2d %.3f "
                 "GB/s (probe %d MiB)", cur["d2h"], cur["h2d"],
                 cur["probe_bytes"] >> 20)
        for d in ("d2h", "h2d"):
            b = cls._AUTO_SPARSE_BELOW_GBPS[d]
            if (prev[d] < b) != (cur[d] < b):
                log.info(
                    "transfer=auto: %s link drifted %.3f -> %.3f "
                    "GB/s across the %.0f s re-probe cadence — "
                    "transport decision flips to %s", d, prev[d],
                    cur[d], cls._LINK_REPROBE_S,
                    "sparse" if cur[d] < b else "dense")

    def transfer_mode(self, dims, transfer: str,
                      direction: str = "d2h") -> str:
        """Effective transport for this shape — the ONE place transport is
        decided: ``auto`` picks sparse exactly when the measured link (in
        the direction this pipeline uses: ``d2h`` for compress, ``h2d``
        for decompress) is slower than that direction's device-stage
        breakeven.  On ``device=cpu`` there is no link to measure, so
        ``auto`` is dense there unless a link value was injected.  Giant
        boxes always take dense: they are split within the box and their
        coefficients come back whole, so pairs could save nothing."""
        if transfer == "auto":
            injected = (self._measured_link_gbps is not None
                        and self._measured_link_at <= 0)
            if self.device.type == "cpu" and not injected:
                return "dense"
            bw = self._link_gbps()[direction]
            transfer = ("sparse"
                        if bw < self._AUTO_SPARSE_BELOW_GBPS[direction]
                        else "dense")
        if transfer == "sparse" and self.giant_ok(dims):
            return "dense"
        return transfer

    def _put(self, data: np.ndarray, device=None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(
            self.device if device is None else device)

    def _host(self, t: torch.Tensor) -> np.ndarray:
        """A device tensor on the host: waits for the kernels that write
        it, then copies."""
        with span("engine.d2h", self.stats, "d2h_seconds"):
            return t.cpu().numpy()

    def _row_chunks(self, n: int):
        """-> ``[(device, lo, hi)]``: the mesh's contiguous row chunks of an
        ``n``-row batch, or the whole batch on the first device when there
        is no mesh or the mesh does not divide ``n``."""
        return mesh_lib.batch_sharding(n, self.mesh, self.device)

    def _map(self, fn, data: np.ndarray) -> list:
        """``fn`` on each row chunk of ``data``, put on the chunk's device
        (``mesh.shard_batch``); every chunk is launched before any result
        is read."""
        with span("engine.h2d", self.stats, "h2d_seconds", args=data.shape):
            xs = mesh_lib.shard_batch(data, self.mesh, self.device)
        with span("engine.launch", self.stats, "launch_seconds"):
            out = [fn(x) for x in xs]
        self._free(xs)
        return out

    def _free(self, tensors: list) -> None:
        """Drop a list's device tensors (span ``engine.free``,
        ``free_seconds``): freeing one takes the GIL anew, which the host
        packer's workers hold for milliseconds."""
        with span("engine.free", self.stats, "free_seconds"):
            tensors.clear()

    def _cat(self, parts: list) -> np.ndarray:
        """Device tensors of consecutive row chunks -> one host array;
        empties ``parts``, so that the tensors only it holds are freed
        (:meth:`_free`)."""
        host = [self._host(p) for p in parts]
        self._free(parts)
        return host[0] if len(host) == 1 else np.concatenate(host)

    def _forward_dev(self, x: torch.Tensor, dims, pack: int = 1):
        """Device forward of a batch array: -> (coeffs, max, min) on the
        device, coefficients in the batch's geometry, extrema per item."""
        if pack > 1:
            return packed_cuda.packed_forward(x, pack)
        eff = self.eff_scales(dims)
        if eff > 1:
            return pyramid_cuda.pyramid_forward(x, eff)
        return haar_cuda.fused_forward(x)

    def _forward(self, data: np.ndarray, dims, pack: int = 1):
        """-> (per-chunk coefficient tensors, max, min on the host)."""
        cs, maxs, mins = map(list, zip(*self._map(
            lambda x: self._forward_dev(x, dims, pack), data)))
        return cs, self._cat(maxs), self._cat(mins)

    def forward_signed_batch(self, data: np.ndarray):
        """-> (coeffs f32 [N, XYZ], signed absmax f32 [N]) of an unpacked
        ``[N, X, Y, Z]`` batch: the transform and the keep-independent half
        of the threshold rule (a keep sweep derives each keep's thresholds
        from ``signed``)."""
        cs, maxv, minv = self._forward(data, data.shape[1:])
        flat = self._cat(cs).reshape(data.shape[0], -1)
        signed = resolve_signed_absmax(maxv, minv,
                                       row_getter=flat.__getitem__)
        return flat, signed

    def compress_batch_raw(self, data: np.ndarray, keep: float):
        """-> (coeffs f32 [N, XYZ], t32 f32 [N]): transform + exact per-item
        thresholds; the host packer applies ``|c| > t32`` during RLE."""
        flat, signed = self.forward_signed_batch(data)
        return flat, threshold.exact_threshold32(signed, keep)

    def compress_batch(self, data: np.ndarray, keep: float):
        """-> (coeffs f32 [N, XYZ], mask bool [N, XYZ]) as NumPy arrays:
        :meth:`compress_batch_raw` with the keep-mask ``|c| > t32``."""
        flat, t32 = self.compress_batch_raw(data, keep)
        return flat, np.abs(flat) > t32[:, None]

    def compress_shapebatch(self, batch: ShapeBatch, keep: float):
        """-> (coefficient ShapeBatch of the same geometry, t32 f32 per
        item incl. padding slots)."""
        self._check_batch(batch)
        if self.giant_ok(batch.shape):
            return self._compress_giant(batch, keep)
        cs, maxv, minv = self._forward(batch.data, batch.shape, batch.pack)
        cb = dataclasses.replace(batch, data=self._cat(cs))
        with span("engine.threshold", self.stats, "threshold_seconds"):
            # a tie resolves against item i's logical coefficients,
            # wherever the batch geometry puts them
            signed = resolve_signed_absmax(
                maxv, minv, row_getter=lambda i: cb.item_view(i).reshape(-1))
            return cb, threshold.exact_threshold32(signed, keep)

    def _compress_giant(self, batch: ShapeBatch, keep: float):
        """Giant-box compress: each item is one box split along X over the
        giant mesh (``distributed.sharded_box_forward``); the coefficients,
        ties and thresholds are the unsplit box's, so the archive is too."""
        eff = self.eff_scales(batch.shape)
        n = batch.data.shape[0]
        gm = self._giant_mesh()
        log.info("Giant box path: %d box(es) of %s sharding X over %d "
                 "devices (%s)", n, batch.shape, gm.size,
                 "slabs gathered over gloo" if gm.spans_processes
                 else "zero collectives")
        coeffs = np.empty_like(batch.data)
        maxs = np.empty(n, np.float32)
        mins = np.empty(n, np.float32)
        for i in range(n):
            coeffs[i], maxs[i], mins[i] = distributed.sharded_box_forward(
                gm, batch.data[i], eff)
        signed = resolve_signed_absmax(
            maxs, mins, row_getter=lambda i: coeffs[i].reshape(-1))
        return (dataclasses.replace(batch, data=coeffs),
                threshold.exact_threshold32(signed, keep))

    def compress_shapebatch_sparse(self, batch: ShapeBatch, keep: float,
                                   cap_fraction: float | None = None):
        """Sparse-transfer compression: the transform AND sparsification run
        on the device; only (counts, kept indices, kept values) come back.

        -> (SparseCoeffs, t32).  Capacity = ``cap_fraction`` of the
        coefficient count; rare overflowing items fall back to a dense
        single-row fetch (handled by :class:`SparseCoeffs.item_pairs`).
        The pair buffers are trimmed on the device to the observed max
        kept count before fetching, and a batch with WIDESPREAD overflow
        ships the dense array alone (pairs would only add traffic) —
        sparse transport never fetches more than dense plus the counts.

        When ``cap_fraction`` is None it ADAPTS: the first batch of a
        shape uses 25%, later batches size the buffer to 1.5x the largest
        kept fraction observed so far (an undersized cap only costs
        overflow fallbacks, never correctness).
        """
        self._check_batch(batch)
        dims = batch.shape
        if self.giant_ok(dims):
            # transfer_mode routes giant shapes dense; the per-device
            # kernels below would run a whole giant box on one device
            raise ValueError(
                f"sparse transfer does not take giant shapes {dims} — "
                "transfer_mode routes them dense (sharded giant path)")
        adaptive = cap_fraction is None
        if adaptive:
            cap_fraction = self._sparse_cap_hint.get(batch.shape, 0.25)
        m = int(np.prod(dims))
        cs, maxv, minv = self._forward(batch.data, dims, batch.pack)
        # item-major logical rows [N, X*Y*Z] per chunk, as the JAX
        # package's _unpack_packed_coeffs makes them from a packed batch
        flats = [(packed_cuda.unpack(c, batch.pack) if batch.pack > 1
                  else c).reshape(-1, m) for c in cs]
        flat = flats[0] if len(flats) == 1 else _ChunkRows(flats)
        with span("engine.threshold", self.stats, "threshold_seconds"):
            signed = resolve_signed_absmax(
                maxv, minv, row_getter=lambda i: self._host(flat[i]))
            t32 = threshold.exact_threshold32(signed, keep)
        # cap rounded UP to a multiple of 128 slots
        cap = int(min(m, max(128, -(-int(m * cap_fraction) // 128) * 128)))
        parts, lo = [], 0
        for f in flats:
            hi = lo + int(f.shape[0])
            parts.append(compact_cuda.compact(
                f, self._put(t32[lo:hi], f.device), cap))
            lo = hi
        counts = self._cat([c for c, _, _ in parts])
        if adaptive and batch.n_valid:
            observed = float(counts[: batch.n_valid].max()) / m
            self._sparse_cap_hint[batch.shape] = float(
                min(0.25, max(observed * 1.5, 64 / m)))
        # the counts (tiny) land first, so the transport can adapt BEFORE
        # the expensive device->host fetch.  Trim the pair buffers to the
        # observed max NON-overflowing count (overflowers never have their
        # pair rows read — item_pairs serves them from the dense fallback,
        # so one spiky box must not pin the whole batch at the cold cap);
        # power-of-2 trim widths.
        n = batch.n_valid
        live = counts[:n][counts[:n] <= cap] if n else counts[:0]
        n_over = n - len(live)
        needed = int(live.max()) if len(live) else 0
        trim = int(min(cap, max(128, 1 << (max(needed, 1) - 1).bit_length())))
        # ship the dense array ALONE whenever pairs + the fallback fetches
        # item_pairs would actually perform (bulk flat fetch when overflow
        # is widespread, else per-item rows) would cost at least as much:
        # the never-more-than-dense transport invariant
        dense_bytes = int(np.prod(flat.shape)) * 4
        fallback_bytes = (dense_bytes if n_over > max(2, n // 10)
                          else n_over * m * 4)
        pair_bytes = len(counts) * trim * 8 + fallback_bytes
        if n and n_over and pair_bytes >= dense_bytes:
            empty = np.zeros((len(counts), 0))
            return SparseCoeffs(shape=dims, items=batch.items,
                                counts=counts,
                                idxs=empty.astype(np.int32),
                                vals=empty.astype(np.float32),
                                cap=0, _flat_dev=flat,
                                _flat_np=self._host(flat.cpu())), t32
        if trim < cap:
            cap = trim
        return SparseCoeffs(shape=dims, items=batch.items,
                            counts=counts,
                            idxs=self._cat([i[:, :cap] for _, i, _ in parts]),
                            vals=self._cat([v[:, :cap] for _, _, v in parts]),
                            cap=cap, _flat_dev=flat), t32

    def _forward_hist(self, data: np.ndarray, pack: int = 1,
                      fetch_coeffs: bool = True):
        """-> (coeffs on the host in the batch's geometry, or None; int64
        histogram of the whole batch, the sum of its chunks')."""
        if pack > 1:
            def fwd(x):
                return packed_cuda.packed_forward_hist(x, pack)
        else:
            eff = max(1, self.eff_scales(data.shape[1:]))

            def fwd(x):
                return pyramid_cuda.forward_hist(x, eff)
        parts = self._map(fwd, data)
        hist = np.zeros(threshold.EXP_HIST_BINS, np.int64)
        for _, h in parts:
            hist += self._host(h)
        if not fetch_coeffs:
            return None, hist
        return self._cat([c for c, _ in parts]), hist

    def forward_hist_shapebatch(self, batch: ShapeBatch, hist_items=None,
                                fetch_coeffs: bool = True):
        """Global-threshold pass: -> (coefficient ShapeBatch, int64
        histogram of the real items).  ``fetch_coeffs=False`` returns
        ``(None, hist)`` and moves no coefficient to the host.

        ``hist_items`` (giant batches split across processes): the item
        indices whose histogram counts.  Every process transforms every
        giant item (each transform is a collective), so only each item's
        owner may count it, or the summed histogram would count giant
        coefficients once per process."""
        self._check_batch(batch)
        if self.giant_ok(batch.shape):
            return self._forward_hist_giant(batch, hist_items, fetch_coeffs)
        c, hist = self._forward_hist(batch.data, batch.pack, fetch_coeffs)
        # padding slots are zero boxes: take their coefficients out of the
        # zero bin so the quantile counts real coefficients only (items,
        # not rows: a packed row holds P items)
        m = int(np.prod(batch.shape))
        n_pad = batch.data.size // m - batch.n_valid
        hist[0] -= n_pad * m
        if not fetch_coeffs:
            return None, hist
        return dataclasses.replace(batch, data=c), hist

    def _forward_hist_giant(self, batch: ShapeBatch, hist_items,
                            fetch_coeffs: bool):
        """The giant branch of :meth:`forward_hist_shapebatch`: K6 per
        X-slab, the box's histogram the sum of its slabs'.  Giant batches
        are never padded."""
        eff = self.eff_scales(batch.shape)
        gm = self._giant_mesh()
        # phase-neutral wording: this runs in the pass-1 histogram stream
        # and in pass-2 re-reads of uncached timesteps
        log.info("Giant box path (global threshold): %d box(es) of %s "
                 "sharding X over %d devices", batch.data.shape[0],
                 batch.shape, gm.size)
        coeffs = np.empty_like(batch.data) if fetch_coeffs else None
        hist = np.zeros(threshold.EXP_HIST_BINS, np.int64)
        for i in range(batch.data.shape[0]):
            # every process launches the histogram's all-reduce of every
            # giant item; ownership gates only whether it counts
            c, h = distributed.sharded_box_forward_hist(
                gm, batch.data[i], eff, fetch_coeffs)
            if hist_items is None or i in hist_items:
                hist += h
            if fetch_coeffs:
                coeffs[i] = c
        if not fetch_coeffs:
            return None, hist
        return dataclasses.replace(batch, data=coeffs), hist

    def forward_hist_batch(self, data: np.ndarray, n_pad_rows: int = 0):
        """-> (flat [N, XYZ], int64 histogram); ``n_pad_rows`` all-zero
        padding rows are taken out of the zero bin."""
        data = np.asarray(data, np.float32)
        c, hist = self._forward_hist(data)
        flat = c.reshape(data.shape[0], -1)
        hist[0] -= n_pad_rows * flat.shape[1]
        return flat, hist

    def _inverse_dev(self, x: torch.Tensor, scales: int,
                     pack: int = 1) -> torch.Tensor:
        """Device inverse of ``scales`` pyramid levels (K4, K2 or K7)."""
        if pack > 1:
            return packed_cuda.packed_inverse(x, pack)
        if scales > 1:
            return pyramid_cuda.pyramid_inverse(x, scales)
        return haar_cuda.fused_inverse(x)

    def _inverse(self, blocks: np.ndarray, pack: int = 1) -> np.ndarray:
        eff = self.eff_scales(blocks.shape[1:])
        return self._cat(self._map(
            lambda x: self._inverse_dev(x, eff, pack), blocks))

    def decompress_shapebatch(self, coeff_batch: ShapeBatch) -> ShapeBatch:
        """Coefficients -> reconstructed boxes, same geometry."""
        self._check_batch(coeff_batch)
        if self.giant_ok(coeff_batch.shape):
            return self._decompress_giant(coeff_batch)
        return dataclasses.replace(
            coeff_batch, data=self._inverse(coeff_batch.data,
                                            coeff_batch.pack))

    def _decompress_giant(self, coeff_batch: ShapeBatch) -> ShapeBatch:
        """Inverse of :meth:`_compress_giant`: per box, the pyramid split
        into X-slab pyramids, each inverted on its giant mesh entry."""
        eff = self.eff_scales(coeff_batch.shape)
        gm = self._giant_mesh()
        out = np.empty_like(coeff_batch.data)
        for i in range(coeff_batch.data.shape[0]):
            out[i] = distributed.sharded_box_inverse(
                gm, coeff_batch.data[i], eff)
        return dataclasses.replace(coeff_batch, data=out)

    def preview_shapebatch(self, batch: ShapeBatch, depth: int):
        """Low-band (LLL) preview at 1/2**depth resolution per axis.

        ``batch`` holds logical-order coefficient rows (halves, pack=1, as
        :meth:`HostPacker.unpack_into` fills them).  Returns ``(array [N,
        X>>depth, Y>>depth, Z>>depth], h2d_bytes)``.

        When ``depth <= eff_scales`` the preview is the stored pyramid's
        corner plus the remaining ``eff - depth`` inverse scales (K2 for
        one, K7 for more): only the corner (8**-depth of the coefficients)
        crosses the host->device link, and at ``depth == eff`` the device
        does no work.  Deeper previews invert fully (K2/K7) and take
        ``haar.haar3d_lowpass`` on the device."""
        dims = tuple(int(d) for d in batch.shape)
        if any(d % (1 << depth) for d in dims):
            raise ValueError(
                f"preview={depth} requires box dims divisible by "
                f"{1 << depth}; got {dims}")
        s_box = self.eff_scales(dims)
        if depth > s_box and self.giant_ok(dims):
            # a deeper-than-stored preview reconstructs the FULL box on
            # one device before re-lowpassing — exactly what a giant box
            # cannot do; the corner path (depth <= scales) stays fine
            # since only 8**-depth of the coefficients reach the device
            raise ValueError(
                f"preview={depth} on a giant box {dims} would "
                f"reconstruct the whole box on one device; use preview "
                f"<= scales ({s_box}) for giant archives")
        cx, cy, cz = (d >> depth for d in dims)
        if depth <= s_box:
            corner = np.ascontiguousarray(batch.data[:, :cx, :cy, :cz])
            rem = s_box - depth
            if rem == 0:
                return corner, 0
            return self._cat(self._map(
                lambda x: self._inverse_dev(x, rem), corner)), corner.nbytes
        return self._cat(self._map(
            lambda x: haar.haar3d_lowpass(self._inverse_dev(x, s_box),
                                          depth),
            batch.data)), batch.data.nbytes

    def rmse_batch(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Per-item RMSE [N] of ``a`` against ``b`` (float32 on the device):
        the JAX package's ``_rmse_step``, a chunked two-stage float32 sum
        (rows of 4096-element chunks, then the chunk sums)."""
        d = (self._put(a) - self._put(b)).reshape(a.shape[0], -1)
        m = d.shape[1]
        sq = d * d
        chunks = max(1, m // 4096)
        pad = -m % chunks
        if pad:
            sq = torch.nn.functional.pad(sq, (0, pad))
        partial = sq.reshape(sq.shape[0], chunks, -1).sum(dim=2)
        return self._host(torch.sqrt(partial.sum(dim=1) / m))

    @staticmethod
    def scatter_rows(idx: torch.Tensor, vals: torch.Tensor,
                     dims) -> torch.Tensor:
        """Padded pairs ``idx`` int32 / ``vals`` f32 ``[n, cap]`` on the
        device -> zeroed coefficient rows ``[n, X, Y, Z]`` holding them.
        Positions >= X*Y*Z are padding: torch has no ``mode="drop"``, so
        slot j's padding goes to spare element j past the rows, which is
        never read (one spare per slot, not one for all: millions of
        stores to one address serialise).  Flat positions are int64 (a
        decompress bucket is unbounded)."""
        n, cap = idx.shape
        m = int(np.prod(dims))
        idx = idx.long()
        dev = idx.device
        pos = idx + torch.arange(n, dtype=torch.int64, device=dev)[:, None] * m
        spare = n * m + torch.arange(cap, dtype=torch.int64, device=dev)
        pos = torch.where(idx < m, pos, spare[None, :])
        flat = torch.zeros(n * m + cap, dtype=torch.float32, device=dev)
        flat.index_put_((pos.reshape(-1),), vals.reshape(-1))
        return flat[: n * m].view((n,) + tuple(dims))

    def decompress_shapebatch_sparse(self, batch: ShapeBatch,
                                     idx: np.ndarray,
                                     vals: np.ndarray) -> ShapeBatch:
        """Sparse-transfer decompress: (logical position, value) pairs ->
        device scatter into zeroed rows -> inverse kernel.

        ``idx`` int32 / ``vals`` f32 ``[n_items, cap]`` as
        :meth:`HostPacker.unpack_sparse` pads them: padding slots carry
        positions >= X*Y*Z.  Only the pairs cross the host->device link.
        The scatter (:meth:`scatter_rows`) is plain torch, as the JAX
        package's is a jnp scatter outside any kernel.  Under a mesh the
        pair rows pad to a mesh multiple and each chunk scatters and
        inverts on its entry.  The output is bitwise the dense path's
        (same coefficients, same inverse kernel)."""
        self._check_batch(batch)
        dims = tuple(int(d) for d in batch.shape)
        m = int(np.prod(dims))
        if self.giant_ok(dims):
            # mirror of the compress-side guard
            raise ValueError(
                f"sparse transfer does not take giant shapes {dims} — "
                "transfer_mode routes them dense (sharded giant path)")
        pad = self.mesh.size if self.mesh is not None else 1
        n_pad = (-idx.shape[0]) % pad
        if n_pad:
            cap = idx.shape[1]
            pad_row = (m + np.arange(cap, dtype=idx.dtype))[None]
            idx = np.concatenate([idx, np.repeat(pad_row, n_pad, axis=0)])
            vals = np.concatenate(
                [vals, np.zeros((n_pad, vals.shape[1]), vals.dtype)])
        idx = np.ascontiguousarray(idx, np.int32)
        eff = self.eff_scales(dims)
        outs = []
        for dev, lo, hi in self._row_chunks(idx.shape[0]):
            with span("engine.h2d", self.stats, "h2d_seconds"):
                idx_dev = torch.from_numpy(idx[lo:hi]).to(dev)
                vals_dev = self._put(vals[lo:hi], dev)
            with span("engine.launch", self.stats, "launch_seconds"):
                outs.append(self._inverse_dev(
                    self.scatter_rows(idx_dev, vals_dev, dims), eff))
        return ShapeBatch(shape=dims, data=self._cat(outs),
                          items=batch.items, n_valid=batch.n_valid)

    def decompress_device_rows(self, coeff_batch: ShapeBatch,
                               rows: torch.Tensor) -> ShapeBatch:
        """:meth:`decompress_shapebatch` of rows that already lie on the
        engine's device (one box a row, the card's decode of a streamed
        bucket's tail): no H2D, the inverse kernel, D2H."""
        self._check_batch(coeff_batch)
        if coeff_batch.pack != 1 or self.mesh is not None or \
                self.giant_ok(coeff_batch.shape):
            raise NotImplementedError(
                "device rows take one box a row on one device")
        eff = self.eff_scales(coeff_batch.shape)
        with span("engine.launch", self.stats, "launch_seconds"):
            out = [self._inverse_dev(rows, eff)]
        return dataclasses.replace(coeff_batch, data=self._cat(out))

    def decompress_batch(self, flat: np.ndarray, dims) -> np.ndarray:
        """flat f32 [N, X*Y*Z] -> boxes f32 [N, X, Y, Z]."""
        dims = tuple(int(d) for d in dims)
        return self._inverse(np.asarray(flat, np.float32).reshape(
            (-1,) + dims))

    def _check_batch(self, batch: ShapeBatch) -> None:
        # spatial batches carry scales=1, coefficient batches eff_scales;
        # lane-packed batches only on the halves route, at scales=1
        if (batch.layout != "halves"
                or batch.scales not in (1, self.eff_scales(batch.shape))
                or (batch.pack != 1 and not (
                    self._halves_ok(batch.shape)
                    and batch.shape[-1] % 2 == 0))):
            raise NotImplementedError(
                f"batch geometry pack={batch.pack} layout={batch.layout!r} "
                f"scales={batch.scales} is not ported (halves; pack=1, or "
                "lane-packed on the halves route at scales=1)")


# what each member of an unpack returns, summed into the packer's stats
_UNPACK_KEYS = ("unpack_cpu_seconds", "xz_decoded_bytes",
                "xz_decode_cpu_seconds")


def _atomic_write(path: str, blob: bytes) -> None:
    """Temp-name + rename so a crash mid-write never leaves a truncated
    output that a resumed run (resume=1) would skip as complete."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


class HostPacker:
    """Parallel host-side pack/unpack + file I/O for ``halves`` batches.

    The member codec is NumPy RLE + xz (``io/archive``: liblzma's buffer
    encoder through ctypes, or stdlib ``lzma``) on the packer's workers.
    Two archive layouts with identical member bytes: ``files`` (one
    ``.xz`` per (t, lev, comp, box), reference-compatible) and ``bundle``
    (one container per timestep; callers must :meth:`close_bundles`).

    The pack side is one stream per packer (``self.stream``,
    :class:`runtime.packstream.PackStream`): :meth:`submit` and
    :meth:`submit_sparse` queue a batch's members and return a Future of
    its bytes at once, and the packer's workers pack the queued members of
    every batch, largest first, with no barrier between batches;
    :meth:`pack` and :meth:`pack_sparse` submit and wait.  Bundle members
    are appended in submission order, and :meth:`close_bundles_later`
    closes a timestep's bundle once the members submitted before it are
    in, so the bytes do not depend on the order the workers finish in.

    ``stats`` (a dict, by default the packer's own) receives from the
    stream ``pack_seconds`` (the union of the intervals in which a batch
    is in flight) and, summed over the members, ``pack_cpu_seconds`` (the
    workers' thread CPU, spans ``pack.size`` and ``pack.member``),
    ``xz_in_bytes`` (serialized payload bytes into the member codec) and
    ``xz_cpu_seconds`` (span ``pack.xz``); on the unpack side
    ``unpack_cpu_seconds``, ``xz_decoded_bytes`` and
    ``xz_decode_cpu_seconds`` (spans ``unpack.member``, ``unpack.xz``).
    The unpack side decodes on :class:`UnpackStream`, the packer's one
    decode pool.
    """

    def __init__(self, workers: int | None = None, payload: str = "f32",
                 codec: str = "xz", xz_preset: int = 6,
                 archive_format: str = "files", xz_delta: int = 0,
                 stats: dict | None = None):
        self.workers = workers or min(32, (os.cpu_count() or 4))
        self.stats = {} if stats is None else stats
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
        self.stream = PackStream(
            self.workers, self.stats,
            append=(self._append_member if archive_format == "bundle"
                    else None),
            close=self._close_writers)

    def _paths(self, dir_, items):
        return [os.path.join(dir_, archive.payload_filename(
            it.t, it.level, it.comp_idx, it.box)) for it in items]

    # ---- bundle plumbing ----

    def _writer(self, dir_: str, t: int) -> bundle.BundleWriter:
        key = (dir_, int(t))
        w = self._writers.get(key)
        if w is None:
            proc = mesh_lib.process_index()
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

    def _append_member(self, dir_: str, it, blob) -> int:
        return self._writer(dir_, it.t).add(it.t, it.level, it.comp_idx,
                                            it.box, blob)

    def _close_writers(self, t: int | None) -> int:
        total = 0
        for key in list(self._writers):
            if t is None or key[1] == int(t):
                total += self._writers.pop(key).close()
        return total

    def close_bundles_later(self, t: int | None = None) -> cf.Future:
        """Finalize open bundles (all, or only timestep ``t``'s), fsync
        included, once every batch submitted before has been appended;
        -> a Future of the container bytes written."""
        return self.stream.close_later(t)

    def close_bundles(self, t: int | None = None) -> int:
        """:meth:`close_bundles_later`, waited for."""
        return self.close_bundles_later(t).result()

    def _bundle_set(self, dir_: str) -> bundle.BundleSet:
        bs = self._bundle_sets.get(dir_)
        if bs is None:
            bs = self._bundle_sets[dir_] = bundle.BundleSet(dir_)
        return bs

    @staticmethod
    def _require_halves(batch: ShapeBatch) -> None:
        """The item views walk halves batches (any pack factor) only."""
        if batch.layout != "halves":
            raise NotImplementedError(
                "the port's packer walks halves batches only")

    def _encode(self, payload: bytes, path):
        """xz (or ``codec=raw``) one serialized member and, in files mode
        (``path`` set), write it; -> (the blob, or its length once written;
        the codec's thread CPU seconds)."""
        with span("pack.xz", cpu=True) as xz:
            blob = archive.encode_blob(payload, self.codec, self.xz_preset)
        if path is None:
            return blob, xz.cpu_seconds
        _atomic_write(path, blob)
        return len(blob), xz.cpu_seconds

    def _serializer(self):
        return (archive.serialize_payload_q16 if self.payload == "q16"
                else archive.serialize_payload)

    def _member(self, out_dir: str, items, shape, pairs):
        """``encode(k)`` for the stream: member ``k``'s
        ``pairs(k) -> (kept positions, values)`` RLE-coded, serialized,
        xz'd and, in files mode, written."""
        paths = (None if self.archive_format == "bundle"
                 else self._paths(out_dir, items))
        serialize = self._serializer()

        def encode(k):
            with span("pack.member", cpu=True) as member:
                idx, vals = pairs(k)
                payload = serialize(shape, rle.rle_encode_pairs(idx), vals)
                out, xz_cpu = self._encode(
                    payload, None if paths is None else paths[k])
            return out, {"pack_cpu_seconds": member.cpu_seconds,
                         "xz_in_bytes": len(payload),
                         "xz_cpu_seconds": xz_cpu}
        return encode

    def submit(self, out_dir: str, coeff_batch: ShapeBatch,
               t32: np.ndarray, subset=None) -> cf.Future:
        """Queue threshold+RLE+xz+write of the items of a coefficient
        ShapeBatch (padding slots ignored; ``subset`` restricts to those
        item indices) and return at once: a Future of the compressed
        bytes (span ``pack.batch``: the hand-over).  Each member is
        sized by its kept count (span ``pack.size``) and packed whole."""
        self._require_halves(coeff_batch)
        sel = (list(range(len(coeff_batch.items))) if subset is None
               else list(subset))
        chosen = [coeff_batch.items[i] for i in sel]
        t32 = np.asarray(t32)

        def size(k):
            with span("pack.size", cpu=True) as s:
                i = sel[k]
                n = int(np.count_nonzero(
                    np.abs(coeff_batch.item_view(i)) > t32[i]))
            return n, {"pack_cpu_seconds": s.cpu_seconds}

        def pairs(k):
            i = sel[k]
            flat = np.ascontiguousarray(coeff_batch.item_view(i)).reshape(-1)
            idx = np.flatnonzero(np.abs(flat) > t32[i])
            return idx, flat[idx]
        encode = self._member(out_dir, chosen, coeff_batch.shape, pairs)
        with span("pack.batch", args=(*coeff_batch.shape, len(sel))):
            return self.stream.submit(coeff_batch.data.nbytes, out_dir,
                                      chosen, size, encode)

    def pack(self, out_dir: str, coeff_batch: ShapeBatch,
             t32: np.ndarray, subset=None) -> int:
        """:meth:`submit`, waited for: the total compressed bytes."""
        return self.submit(out_dir, coeff_batch, t32, subset).result()

    def submit_sparse(self, out_dir: str, sparse: SparseCoeffs,
                      t32: np.ndarray) -> cf.Future:
        """Queue the pack of device-sparsified (index, value) pairs — no
        dense coefficient array ever reaches the host — and return at
        once: a Future of the compressed bytes.  Bytes identical to the
        dense path (same mask, same RLE)."""
        encode = self._member(out_dir, sparse.items, sparse.shape,
                              lambda k: sparse.item_pairs(k, float(t32[k])))
        with span("pack.batch", args=(*sparse.shape, len(sparse.items))):
            return self.stream.submit(
                sparse.transfer_bytes(), out_dir, sparse.items,
                lambda k: (int(sparse.counts[k]), {}), encode)

    def pack_sparse(self, out_dir: str, sparse: SparseCoeffs,
                    t32: np.ndarray) -> int:
        """:meth:`submit_sparse`, waited for."""
        return self.submit_sparse(out_dir, sparse, t32).result()

    def unpack_sparse(self, in_dir: str, batch: ShapeBatch):
        """Decode payloads to padded (logical position, value) pair arrays
        for the sparse-transfer decompress path: returns
        ``(idx int32 [n_items, cap], vals f32 [n_items, cap])`` where
        padding slots carry distinct positions >= X*Y*Z (dropped by the
        device scatter).  Only kept pairs ever materialize — no dense rows
        on the host and only ~kept bytes over the host->device link."""
        items = batch.items
        m = int(np.prod(batch.shape))
        pairs = [None] * len(items)

        def keep(i, total, runs, vals):
            # shared helper = the single home of the malformed-stream
            # semantics (reference's skip-increment rule), so sparse and
            # dense decompress can never drift apart on corrupt payloads
            pos, v = rle.rle_decode_pairs(runs, vals, total)
            pairs[i] = (pos.astype(np.int32), v)

        with self._decode(in_dir, items, batch.shape, [(0, len(items))],
                          keep) as stream:
            list(stream)
        cap = max([len(p) for p, _ in pairs] + [1])
        # round the pad capacity up to a power of two, but never past the
        # box volume (a 256 floor on an m=64 box would ship MORE bytes
        # than the dense row)
        cap = min(max(256, 1 << (cap - 1).bit_length()),
                  1 << (m - 1).bit_length())
        # padding slots get distinct out-of-range positions m, m+1, ...
        idx = np.tile(m + np.arange(cap, dtype=np.int32),
                      (len(items), 1))
        vals = np.zeros((len(items), cap), np.float32)
        for i, (p, v) in enumerate(pairs):
            idx[i, :len(p)] = p
            vals[i, :len(p)] = v
        return idx, vals

    def unpack_into(self, in_dir: str, batch: ShapeBatch) -> None:
        """Read + xz-decode + RLE-scatter every item into ``batch.data``:
        :meth:`unpack_stream` with one chunk of every row."""
        with self.unpack_stream(in_dir, batch,
                                [(0, len(batch.items))]) as stream:
            list(stream)

    def stored_sizes(self, in_dir: str, items) -> list:
        """Each of ``items``' stored member's size, read from the bundle
        index or the file system without reading a member; a member that
        is missing counts 0 (its decode raises as ever)."""
        if self.archive_format == "bundle":
            bs = self._bundle_set(in_dir)
            locs = [bs.locate(it.t, it.level, it.comp_idx, it.box)
                    for it in items]
            return [loc[2] if loc else 0 for loc in locs]
        sizes = []
        for path in self._paths(in_dir, items):
            try:
                sizes.append(os.path.getsize(path))
            except OSError:
                sizes.append(0)
        return sizes

    def largest_first(self, in_dir: str, items) -> list:
        """``items`` by their stored member's size (:meth:`stored_sizes`),
        largest first, ties in the given order."""
        sizes = self.stored_sizes(in_dir, items)
        order = sorted(range(len(items)), key=lambda i: -sizes[i])
        return [items[i] for i in order]

    def read_blobs(self, in_dir: str, items) -> list:
        """The stored members of ``items``, read on the calling thread."""
        read = self._reader(in_dir, items)
        return [read(i) for i in range(len(items))]

    def unpack_stream(self, in_dir: str, batch: ShapeBatch,
                      bounds) -> "UnpackStream":
        """The unpack of ``batch``: each item read, xz-decoded and
        RLE-scattered into ``batch.data`` on a pool that hands the rows on
        a chunk of ``bounds`` at a time (see :class:`UnpackStream`;
        :meth:`unpack_into` takes one chunk)."""
        self._require_halves(batch)
        dims = tuple(batch.shape)

        def scatter(i, total, runs, vals):
            batch.item_write(i, rle.rle_decode(runs, vals, total)
                             .reshape(dims))
        return self._decode(in_dir, batch.items, dims, bounds, scatter)

    def _reader(self, in_dir: str, items):
        """``read(i)`` -> member ``i``'s stored bytes (a bundle's located
        here, a file's read when called)."""
        if self.archive_format == "bundle":
            bs = self._bundle_set(in_dir)
            return [bs.blob(it.t, it.level, it.comp_idx, it.box)
                    for it in items].__getitem__
        paths = self._paths(in_dir, items)

        def read(i):
            with open(paths[i], "rb") as f:
                return f.read()
        return read

    def _decode(self, in_dir: str, items, dims, bounds,
                use) -> "UnpackStream":
        """Every member of ``items`` read (a bundle's here, files on the
        pool), xz-decoded, deserialized and checked against ``dims`` (its
        shape and its total), then handed to ``use(i, total, runs,
        vals)``, on an :class:`UnpackStream` over ``bounds``."""
        dims = tuple(dims)
        m = int(np.prod(dims))
        read = self._reader(in_dir, items)
        deserialize = (archive.deserialize_payload_q16
                       if self.payload == "q16"
                       else archive.deserialize_payload)

        def one(i):
            with span("unpack.member", cpu=True) as member:
                blob = read(i)
                with span("unpack.xz", cpu=True) as xz:
                    payload = archive.decode_blob(blob, self.codec)
                shape, total, runs, vals = deserialize(payload)
                if tuple(shape) != dims:
                    raise ValueError(
                        f"payload shape {tuple(shape)} disagrees with "
                        f"dimensions.raw {dims}")
                if int(total) != m:
                    raise ValueError(
                        f"payload total {int(total)} disagrees with "
                        f"dimensions.raw volume {m}")
                use(i, total, runs, vals)
            return member.cpu_seconds, len(payload), xz.cpu_seconds
        return UnpackStream(self, one, len(items), bounds)


def _timed(one, i):
    """``one(i)`` and the ``perf_counter`` at its end."""
    out = one(i)
    return out, time.perf_counter()


class UnpackStream:
    """The members of a batch decoding on a pool of the packer's workers,
    submitted in row order, and handed on a chunk of rows at a time.

    ``bounds`` are the chunks' ``[lo, hi)`` rows, in order; rows past the
    batch's items are padding.  Iterating yields each chunk's ``(lo, hi)``
    in order, once every member in it has decoded, so the caller can work
    on a chunk while the pool decodes the later ones; a member's error (the
    ``ValueError`` of a corrupt member) raises when its chunk is reached.
    The wait takes each member's result in turn, a constant cost a member
    (``concurrent.futures.wait`` on the pending set would cost one a
    pending member at every wake-up).  :meth:`close`, or leaving the
    ``with`` block, cancels the members not yet started and waits for those
    running, so no worker outlives the stream, and adds the decoded
    members' counters to the packer's stats.  ``decoded`` is the
    ``perf_counter`` at the end of the last member decoded."""

    def __init__(self, packer: HostPacker, one, n_items: int, bounds):
        self._packer = packer
        self._bounds = list(bounds)
        self._chunks = []       # each chunk's futures, in row order
        self._next = 0
        self._results = []
        self.decoded = time.perf_counter()
        self._pool = cf.ThreadPoolExecutor(packer.workers,
                                           thread_name_prefix="wtc-unpack")
        try:
            for lo, hi in self._bounds:
                self._chunks.append([self._pool.submit(_timed, one, i)
                                     for i in range(lo, min(hi, n_items))])
        except BaseException:
            self.close()
            raise

    def __iter__(self):
        return self

    def __next__(self) -> tuple:
        k = self._next
        if k == len(self._chunks):
            raise StopIteration
        self._next += 1
        for f in self._chunks[k]:
            out, end = f.result()
            self._results.append(out)
            self.decoded = max(self.decoded, end)
        return self._bounds[k]

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)
        results, self._results = self._results, []
        stats = self._packer.stats
        for k, key in enumerate(_UNPACK_KEYS):
            stats[key] = stats.get(key, 0) + sum(r[k] for r in results)

    def __enter__(self) -> "UnpackStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
