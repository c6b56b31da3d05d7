"""Entry points for a quick check of the port: one compress step, and one
run of every collective step over a mesh.  The counterparts of the JAX
package's ``__graft_entry__.py`` (``entry``, ``dryrun_multichip``).

Both run on the card unless the caller asks for the CPU
(``device="cpu"``); neither falls back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from wavelet_tpu_torch.runtime import batching, distributed
from wavelet_tpu_torch.runtime import engine as engine_mod
from wavelet_tpu_torch.runtime import mesh as mesh_lib

__all__ = ["entry", "dryrun_multichip"]


def entry(device: str = "cuda"):
    """-> ``(fn, example_args)``: the flagship compute path, the batched
    3D Haar forward (K1) and the per-box signed absmax, on ``[N, X, Y,
    Z]`` float32 boxes; ``fn(*example_args) -> (flat [8, 32768], signed
    absmax [8])``."""
    mesh = mesh_lib.data_mesh([device])
    rng = np.random.default_rng(0)
    example = rng.standard_normal((8, 16, 32, 64)).astype(np.float32)
    return distributed.make_parity_compress_step(mesh), (example,)


def _mesh(n_devices: int, device: str):
    """``n_devices`` entries: the cards in turn (repeating them when there
    are fewer), or CPU entries for ``device="cpu"``."""
    if mesh_lib.resolve_device(device).type == "cpu":
        return mesh_lib.data_mesh(["cpu"] * n_devices)
    cards = torch.cuda.device_count()
    return mesh_lib.data_mesh([torch.device("cuda", i % cards)
                               for i in range(n_devices)])


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """One run of every collective step on an ``n_devices``-entry mesh:
    the train step (forward, global threshold, mask, inverse, RMSE), the
    parity step, one giant box split along X through the two-scale
    pyramid and back (bitwise the unsplit round trip), and a mixed batch
    plan of giant and normal shapes through the engine (compress,
    decompress, and the global pass with and without the coefficient
    fetch).  Raises on any disagreement; -> the step's threshold and
    RMSE."""
    mesh = _mesh(n_devices, device)
    rng = np.random.default_rng(1)
    batch = rng.standard_normal((2 * n_devices, 4, 4, 8)).astype(np.float32)
    recon, thr, rmse = distributed.make_train_step(mesh, 0.1)(batch)
    if recon.shape != batch.shape or not (float(thr) >= 0.0
                                          and np.isfinite(rmse)):
        raise AssertionError(f"train step: {recon.shape}, {thr}, {rmse}")
    flat, _ = distributed.make_parity_compress_step(mesh)(batch)
    if flat.shape != (2 * n_devices, 4 * 4 * 8):
        raise AssertionError(f"parity step: {flat.shape}")

    # one box split along X, two scales, against the unsplit round trip
    box = rng.standard_normal((4 * n_devices, 8, 8)).astype(np.float32)
    back = distributed.make_sharded_box_inverse_interleaved(mesh, 2)(
        distributed.make_sharded_box_forward_interleaved(mesh, 2)(box))
    eng = engine_mod.CodecEngine(device=mesh.devices[0], scales=2)
    ref = eng.decompress_batch(
        eng.forward_signed_batch(box[None])[0], box.shape)[0]
    if not np.array_equal(back.view(np.int32), ref.view(np.int32)):
        raise AssertionError("split round trip differs from the unsplit one")

    # giant and normal shapes planned together; the normal shapes stay
    # below the giant size at every n_devices
    eng = engine_mod.CodecEngine(device=mesh.devices[0], mesh=mesh,
                                 giant_box_bytes=box.nbytes)
    shapes = [box.shape, (4, 8, 8), (4, 8, 8), (6, 5, 7)]
    if not eng.giant_ok(shapes[0]) or eng.giant_ok(shapes[1]):
        raise AssertionError("giant gate")
    entries = [(batching.WorkItem(0, 0, 0, i),
                rng.standard_normal(s).astype(np.float32))
               for i, s in enumerate(shapes)]
    for b in batching.plan_batches(entries, pack_fn=eng.pack_factor,
                                   pad_fn=eng.pad_multiple_for):
        coeffs, _ = eng.compress_shapebatch(b, keep=0.99)
        if eng.decompress_shapebatch(coeffs).data.shape != b.data.shape:
            raise AssertionError(f"round trip shape of {b.shape}")
        _, hist = eng.forward_hist_shapebatch(b)
        none, hist2 = eng.forward_hist_shapebatch(b, fetch_coeffs=False)
        if none is not None or not np.array_equal(hist, hist2):
            raise AssertionError(f"global pass of {b.shape}")
    return {"threshold": float(thr), "rmse": float(rmse)}
