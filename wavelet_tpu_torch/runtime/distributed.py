"""Giant boxes split along X, and the collective steps: the port's
counterpart of ``wavelet_tpu/runtime/distributed.py``.

**Giant boxes.**  A box too large for one device's working set is cut into
``D = mesh.size`` X-slabs ``[X/D, Y, Z]``, one per mesh entry.  Every Haar
pair along X at every scale stays inside one slab when ``X/D`` divides by
``2**scales`` (``CodecEngine.giant_ok``), so each entry runs the ordinary
kernels on its slab — ``haar_cuda.fused_forward`` (K1) or
``pyramid_cuda.pyramid_forward`` (K5), ``pyramid_cuda.forward_hist`` (K6)
for the global pass, ``fused_inverse`` (K2) or ``pyramid_inverse`` (K7) —
and no data crosses between slabs during a transform.

The JAX package gets a layout that needs no regroup from its interleaved
coefficients; the port keeps the halves layout, so the host regroups the
X rows of the D slab pyramids into the whole box's pyramid
(:func:`assemble`) and back (:func:`split`).  Scale s of a slab writes its
X low half over rows ``[0, xs/2)`` and its high half over ``[xs/2, xs)``
of its current corner, so the whole box's corner at scale s takes slab
k's low rows at ``k*xs/2`` and its high rows at ``cx/2 + k*xs/2``; that
regroup applies to the whole current corner ``[cx, cy, cz]`` (the Y and Z
passes never mix slabs), and the next scale repeats it inside the LLL
corner with ``cx/2`` and ``xs/2``.  The regroup only moves values, so the
assembled pyramid is bitwise the whole-box ``haar3d_forward_multi``.

Over a :class:`~wavelet_tpu_torch.runtime.mesh.GlobalMesh`
(``giantmesh=global``) the slabs belong to every process of the group:
each process holds the whole box, runs only its own slabs on its own
entries (:func:`giant_from_process_slabs`), and the slab pyramids,
extrema and reconstructions are all-gathered over gloo as equal-size CPU
tensors (:func:`gather_giant`); the histogram is one int64 gloo
``all_reduce``.  Every process must call each of these functions for
every giant box, in the same order: each is a collective.

**Collective steps.**  :func:`make_parity_compress_step`,
:func:`make_global_compress_step`, :func:`make_train_step` and
:func:`make_sharded_box_forward` / :func:`make_sharded_box_inverse` build
the JAX package's ``shard_map`` programs over a ``DeviceMesh`` (or a
``GlobalMesh``): one kernel launch per entry's row chunk
(``mesh.shard_batch``), the ``psum``s as sums over the entries and, when
the mesh spans processes, over gloo.  They take host arrays and return
host arrays; over a ``GlobalMesh`` every process passes the whole batch
and gets back its own rows.

``gloo_bytes`` counts the bytes this process sent to the group's
collectives here (all-gathers and all-reduces).
"""

from __future__ import annotations

import numpy as np
import torch

from wavelet_tpu_torch.core import threshold
from wavelet_tpu_torch.kernels import haar_cuda, pyramid_cuda
from wavelet_tpu_torch.runtime import mesh as mesh_lib

__all__ = ["slab_row_map", "assemble", "split", "giant_from_process_slabs",
           "gather_giant", "sharded_box_forward", "sharded_box_forward_hist",
           "sharded_box_inverse", "make_sharded_box_forward",
           "make_sharded_box_inverse", "make_sharded_box_forward_interleaved",
           "make_sharded_box_inverse_interleaved",
           "make_parity_compress_step", "make_global_compress_step",
           "kept_count", "make_train_step", "gloo_bytes"]

gloo_bytes = {"all_gather": 0, "all_reduce": 0}


def slab_row_map(cx: int, d: int) -> np.ndarray:
    """Rows of one scale's regroup: the whole box's row j of a ``cx``-row
    corner comes from row ``src[j]`` of the D slabs' corners stacked along
    X (each ``cx/d`` rows)."""
    xs = cx // d
    h = xs // 2
    base = (np.arange(d) * xs)[:, None] + np.arange(h)[None, :]
    return np.concatenate([base.reshape(-1), (base + h).reshape(-1)])


def _corners(shape, scales: int):
    x, y, z = shape
    return [(x >> s, y >> s, z >> s) for s in range(scales)]


def assemble(slabs: np.ndarray, scales: int) -> np.ndarray:
    """``[D, X/D, Y, Z]`` slab pyramids -> the ``[X, Y, Z]`` box pyramid."""
    d, xs, y, z = slabs.shape
    out = np.ascontiguousarray(slabs.reshape(d * xs, y, z))
    for cx, cy, cz in _corners(out.shape, scales):
        out[:cx, :cy, :cz] = out[slab_row_map(cx, d), :cy, :cz]
    return out


def split(coeffs: np.ndarray, d: int, scales: int) -> np.ndarray:
    """Inverse of :func:`assemble`: ``[X, Y, Z]`` -> ``[D, X/D, Y, Z]``."""
    x, y, z = coeffs.shape
    out = np.array(coeffs, dtype=np.float32, copy=True)
    for cx, cy, cz in reversed(_corners(out.shape, scales)):
        out[slab_row_map(cx, d), :cy, :cz] = out[:cx, :cy, :cz].copy()
    return out.reshape(d, x // d, y, z)


def _all_reduce(x: np.ndarray) -> np.ndarray:
    """Sum of ``x`` over the process group (gloo, host tensor)."""
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(x))
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    gloo_bytes["all_reduce"] += t.numel() * t.element_size()
    return t.numpy()


def _process_rows(mesh, x: int) -> slice:
    """This process's X rows of a box split over ``mesh``: ``[p*X/P,
    (p+1)*X/P)`` for process p of P."""
    if x % mesh.size:
        raise ValueError(f"X={x} does not split into {mesh.size} slabs")
    xs = x // mesh.size
    return slice(mesh.offset * xs, (mesh.offset + len(mesh.devices)) * xs)


def giant_from_process_slabs(mesh, local_slab: np.ndarray,
                             global_shape) -> list:
    """This process's contiguous X rows of one giant box (rows
    ``[p*X/P, (p+1)*X/P)``, host numpy) -> one ``[1, X/D, Y, Z]`` float32
    tensor per entry of this process, each on its entry.  The port's
    counterpart of JAX's ``jax.make_array_from_process_local_data``
    placement; ``global_shape`` is the whole box's."""
    n = len(mesh.devices)
    if local_slab.shape[0] * mesh.size != int(global_shape[0]) * n:
        raise ValueError(f"a slab of {local_slab.shape[0]} rows is not this "
                         f"process's share of {tuple(global_shape)} over "
                         f"{mesh.size} entries")
    parts = local_slab.reshape(n, -1, *local_slab.shape[1:])
    return [torch.from_numpy(np.ascontiguousarray(parts[k], np.float32)
                             [None]).to(dev)
            for k, dev in enumerate(mesh.devices)]


def gather_giant(mesh, local: np.ndarray) -> np.ndarray:
    """This process's per-entry results ``[n_local, ...]`` -> every
    entry's ``[D, ...]`` in slab order, on every process: one gloo
    all-gather of equal-size CPU tensors when the mesh spans processes,
    else ``local`` itself (all of a one-process mesh's slabs are here)."""
    if not mesh.spans_processes:
        return local
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(local))
    parts = [torch.empty_like(t) for _ in range(mesh.n_procs)]
    dist.all_gather(parts, t)
    gloo_bytes["all_gather"] += t.numel() * t.element_size()
    return torch.cat(parts).numpy()


def _local_slabs(mesh, box: np.ndarray) -> list:
    return giant_from_process_slabs(
        mesh, box[_process_rows(mesh, box.shape[0])], box.shape)


def _gather_pyramids(mesh, coeffs, scales: int) -> np.ndarray:
    """Slab pyramids ``[1, X/D, Y, Z]`` on this process's entries -> the
    whole box's pyramid, on every process."""
    local = np.concatenate([c.cpu().numpy() for c in coeffs])
    return assemble(gather_giant(mesh, local), scales)


def sharded_box_forward(mesh, box: np.ndarray, scales: int):
    """One giant box ``[X, Y, Z]`` -> (its pyramid ``[X, Y, Z]``, max,
    min): each of this process's slabs through K1 (scales 1) or K5 on its
    entry; the extrema are the NaN-propagating max/min over every slab's
    (gathered per slab, reduced on the host)."""
    outs = [haar_cuda.fused_forward(s) if scales == 1
            else pyramid_cuda.pyramid_forward(s, scales)
            for s in _local_slabs(mesh, box)]
    coeffs = _gather_pyramids(mesh, [c for c, _, _ in outs], scales)
    ext = gather_giant(mesh, np.array(
        [[float(mx[0]), float(mn[0])] for _, mx, mn in outs], np.float32))
    return coeffs, np.max(ext[:, 0]), np.min(ext[:, 1])


def sharded_box_forward_hist(mesh, box: np.ndarray, scales: int,
                             fetch_coeffs: bool = True):
    """One giant box -> (its pyramid or None, int64 magnitude histogram of
    the whole box): each of this process's slabs through K6 on its entry.
    The box's histogram is the sum of every slab's (the same
    coefficients, counted once each), over the process group when the mesh
    spans processes; the kernel counts with 64-bit atomics, so no slab
    needs the 2**31-element segmenting the JAX package's 32-bit device
    histogram does.  ``fetch_coeffs=False`` skips the pyramid gather."""
    outs = [pyramid_cuda.forward_hist(s, scales)
            for s in _local_slabs(mesh, box)]
    hist = np.zeros(threshold.EXP_HIST_BINS, np.int64)
    for _, h in outs:
        hist += h.cpu().numpy()
    if mesh.spans_processes:
        hist = _all_reduce(hist)
    if not fetch_coeffs:
        return None, hist
    return _gather_pyramids(mesh, [c for c, _ in outs], scales), hist


def sharded_box_inverse(mesh, coeffs: np.ndarray, scales: int) -> np.ndarray:
    """Inverse of :func:`sharded_box_forward`: the box pyramid split into
    slab pyramids (on every process, which holds it whole), this
    process's slabs through K2 (scales 1) or K7 on its entries, every
    slab gathered and concatenated along X."""
    mine = split(coeffs, mesh.size, scales)[
        mesh.offset:mesh.offset + len(mesh.devices)]
    outs = [haar_cuda.fused_inverse(s) if scales == 1
            else pyramid_cuda.pyramid_inverse(s, scales)
            for s in giant_from_process_slabs(
                mesh, np.concatenate(mine), coeffs.shape)]
    local = np.concatenate([o.cpu().numpy() for o in outs])
    return np.concatenate(gather_giant(mesh, local))


def _check_halves_mesh(mesh) -> None:
    if mesh.size % 2:
        raise ValueError("the sharded-box transform needs an even number "
                         f"of mesh entries, not {mesh.size}")


def _check_extent(mesh, x: int, q: int) -> None:
    if x % mesh.size or (x // mesh.size) % q:
        raise ValueError(f"slab X extent of {x} rows over {mesh.size} "
                         f"entries must divide by {q}")


def make_sharded_box_forward(mesh):
    """-> ``fwd(box [X, Y, Z]) -> coeffs [X, Y, Z]``: the one-scale
    (halves) forward Haar of one giant box split along X over ``mesh``,
    K1 per slab and the host regroup (:func:`assemble`) — bitwise JAX's
    four-``ppermute`` exchange.  As in JAX: an even number of entries and
    an even slab extent."""
    _check_halves_mesh(mesh)

    def fwd(box):
        _check_extent(mesh, box.shape[0], 2)
        return sharded_box_forward(mesh, box, 1)[0]

    return fwd


def make_sharded_box_inverse(mesh):
    """Inverse of :func:`make_sharded_box_forward` (X, then Y, then Z per
    slab after the regroup is undone by :func:`split`)."""
    _check_halves_mesh(mesh)

    def inv(coeffs):
        _check_extent(mesh, coeffs.shape[0], 2)
        return sharded_box_inverse(mesh, coeffs, 1)

    return inv


def make_sharded_box_forward_interleaved(mesh, scales: int = 1):
    """The counterpart of JAX's zero-collective interleaved ``make_*``:
    :func:`sharded_box_forward` at ``scales``.  The port's coefficients
    are in the halves (logical) layout, so the slab pyramids are
    regrouped on the host; every slab extent must divide by
    ``2**max(1, scales)``."""
    q = 1 << max(1, int(scales))

    def fwd(box):
        _check_extent(mesh, box.shape[0], q)
        return sharded_box_forward(mesh, box, scales)[0]

    return fwd


def make_sharded_box_inverse_interleaved(mesh, scales: int = 1):
    """Inverse of :func:`make_sharded_box_forward_interleaved`:
    :func:`sharded_box_inverse` at ``scales``."""
    q = 1 << max(1, int(scales))

    def inv(coeffs):
        _check_extent(mesh, coeffs.shape[0], q)
        return sharded_box_inverse(mesh, coeffs, scales)

    return inv


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def make_parity_compress_step(mesh):
    """-> ``step(batch [N, X, Y, Z]) -> (flat [N, XYZ], signed absmax
    [N])``: one K1 launch per entry's row chunk, then the per-box signed
    extremum (``resolve_signed_absmax``: the reference's first-occurrence
    rule on exact ties).  No collective: every item is independent."""
    def step(batch):
        outs = [haar_cuda.fused_forward(c)
                for c in mesh_lib.shard_batch(batch, mesh)]
        flat = np.concatenate([_host(c).reshape(c.shape[0], -1)
                               for c, _, _ in outs])
        maxv = np.concatenate([_host(mx) for _, mx, _ in outs])
        minv = np.concatenate([_host(mn) for _, _, mn in outs])
        return flat, threshold.resolve_signed_absmax(
            maxv, minv, row_getter=flat.__getitem__)

    return step


def kept_count(limbs) -> int:
    """Recombine :func:`make_global_compress_step`'s two-limb kept count
    (``[sum of lo16, sum of hi16]``) into the exact global count."""
    lo, hi = (int(v) for v in np.asarray(limbs))
    return lo + (hi << 16)


def _forward_hist_chunks(mesh, batch):
    """K6 (one scale) per entry's row chunk -> (chunks, coefficient
    chunks, the int64 histogram of this process's rows on the first
    chunk's device)."""
    chunks = mesh_lib.shard_batch(batch, mesh)
    outs = [pyramid_cuda.forward_hist(c, 1) for c in chunks]
    dev = chunks[0].device
    hist = sum(h.to(dev) for _, h in outs)
    return chunks, [c for c, _ in outs], hist


def make_global_compress_step(mesh, keep_fraction: float,
                              n_pad_rows: int = 0):
    """-> ``step(batch [N, X, Y, Z]) -> (masked coeffs [N, XYZ], the
    global threshold, kept count int64 [2])``.

    K6 per entry's chunk gives the coefficients and their histogram; the
    int64 histograms sum over the entries (and over gloo when the mesh
    spans processes), the threshold is taken on the card
    (``threshold_from_histogram_device``: the host pipeline's bins and
    rule), and ``|c| > t`` masks each chunk.  ``n_pad_rows`` zero rows
    appended to reach a mesh multiple leave the quantile.  The kept count
    comes back as two 16-bit limb sums, recombined by :func:`kept_count`,
    as in the JAX package."""
    group = mesh_lib.process_group(mesh)

    def step(batch):
        chunks, coeffs, hist = _forward_hist_chunks(mesh, batch)
        m = int(np.prod(batch.shape[1:]))
        n_pad = int(n_pad_rows) * m
        thr = threshold.threshold_from_histogram_device(
            hist, keep_fraction, batch.shape[0] * m - n_pad,
            pad_zeros=n_pad, group=group)
        masked, kept = [], np.zeros(2, np.int64)
        for c in coeffs:
            flat = c.reshape(c.shape[0], -1)
            mask = flat.abs() > thr.to(flat.device)
            local = int(mask.sum())
            kept += (local & 0xFFFF, local >> 16)
            masked.append(_host(torch.where(
                mask, flat, torch.zeros((), device=flat.device))))
        if group is not None:
            kept = _all_reduce(kept)
        return np.concatenate(masked), _host(thr), kept

    return step


def make_train_step(mesh, keep_fraction: float = 0.05):
    """-> ``step(batch [N, X, Y, Z]) -> (reconstruction [N, X, Y, Z],
    the global threshold, RMSE)``: the whole lossy round trip of the
    global mode — K6 per chunk, the global threshold over every entry
    (and process), the mask, K2 per chunk, and the RMSE of the
    reconstruction, its squared error summed in float64 over the entries
    (and over gloo)."""
    group = mesh_lib.process_group(mesh)

    def step(batch):
        chunks, coeffs, hist = _forward_hist_chunks(mesh, batch)
        n = int(np.prod(batch.shape))
        thr = threshold.threshold_from_histogram_device(
            hist, keep_fraction, n, group=group)
        recon, sq = [], np.zeros(1, np.float64)
        for x, c in zip(chunks, coeffs):
            masked = torch.where(c.abs() > thr.to(c.device), c,
                                 torch.zeros((), device=c.device))
            r = haar_cuda.fused_inverse(masked)
            sq += float((r - x).double().square().sum())
            recon.append(_host(r))
        if group is not None:
            sq = _all_reduce(sq)
        return (np.concatenate(recon), _host(thr),
                np.float32(np.sqrt(sq[0] / n)))

    return step
