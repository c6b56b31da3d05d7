"""``regen``: set-up makes the archive with the traffic's
``compress_options``; the window runs ``iter_decompressed_timesteps`` over
all of it, pass after pass, holding every box in host memory.  The check
reads every box of the first pass and of two passes drawn from the seed
against the reference's regenerated boxes, and every box's shape in every
pass."""

from __future__ import annotations

import os
import time

import numpy as np

from wtbench.drivers import Base, sync
from wtbench.reference import archive as ref_archive
from wtbench.reference import check, codec

LIMITS = {"missing_boxes": 0, "wrong_boxes": 0}
HELD_PASSES = 2     # besides the first, drawn from passes 1-15


def _missing(ds, t: int, regen) -> int:
    """Boxes of snapshot ``t`` that ``regen`` lacks or holds at another
    shape, and boxes it holds beyond them."""
    missing = 0
    ncomp = len(ds.components)
    want = ds.snapshots[t].boxes
    for lev, boxes in enumerate(want):
        got = regen[lev] if lev < len(regen) else []
        for b, arr in enumerate(boxes):
            have = got[b] if b < len(got) else None
            missing += have is None or \
                tuple(have.shape) != (ncomp,) + arr.shape[1:]
        missing += max(0, len(got) - len(boxes))
    return missing + max(0, len(regen) - len(want))


class Driver(Base):
    produces = "boxes"

    def setup(self):
        self.archive = os.path.join(self.ctx.work, "archive")
        self.compress(self.archive,
                      **self.ctx.traffic.get("compress_options", {}))
        self.ctx.written += ref_archive.dir_bytes(self.archive)
        self._pass(None, hold=False)       # warm-up: every bucket

    def _pass(self, record, hold: bool):
        from wavelet_tpu_torch.pipeline import common
        from wavelet_tpu_torch.pipeline.decompress import \
            iter_decompressed_timesteps

        stats = {}
        cfg = common.Config(compressed_dir=self.archive,
                            device=self.ctx.device)
        n_times = 0
        for t, _name, regen, *_rest in iter_decompressed_timesteps(
                cfg, stats=stats):
            n_times += 1
            if record is None:
                continue
            record["missing"] += _missing(self.ds, t, regen)
            if hold:
                record["held"] += [((t, lev, b), arr)
                                   for lev, boxes in enumerate(regen)
                                   for b, arr in enumerate(boxes)]
        if record is not None:
            record["missing"] += sum(
                sum(len(b) for b in s.boxes)
                for s in self.ds.snapshots[n_times:])
        return stats

    def window(self, seconds):
        rng = np.random.default_rng([self.ctx.seed, 11])
        held = {0, *(int(v) for v in rng.choice(
            np.arange(1, 16), HELD_PASSES, replace=False))}

        def one_pass(i):
            rec = {"missing": 0, "held": []}
            t0 = time.perf_counter()
            stats = self._pass(rec, i in held)
            sync(self.ctx.device)
            rec.update(wall=time.perf_counter() - t0, stats=stats,
                       f32_bytes=self.ds.f32_bytes(),
                       items=sum(1 for _ in self.ds.items()))
            return rec
        return self.passes(seconds, one_pass)

    def check(self, records):
        held = [h for r in records for h in r["held"]]
        wrong = check.compare_regen(self.ds, self.keep, held, self.ctx.device)
        bad, k = 0, 0
        for r in records:
            n = len(r["held"])
            bad += bool(r["missing"] or any(wrong[k:k + n]))
            k += n
        return {"missing_boxes": sum(r["missing"] for r in records),
                "wrong_boxes": sum(wrong)}, bad


def control(ds, traffic, seed, device, dtype):
    import torch

    keep = float(traffic.get("keep", 0.999))
    held = [((t, lev, b), codec.regenerate(
        torch.from_numpy(arr).to(device), keep, dtype).cpu().numpy())
        for t, s in enumerate(ds.snapshots)
        for lev, boxes in enumerate(s.boxes)
        for b, arr in enumerate(boxes)]
    return {"missing_boxes": 0,
            "wrong_boxes": sum(check.compare_regen(ds, keep, held, device))}
