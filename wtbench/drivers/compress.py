"""``compress``: passes of ``wavelet_tpu_torch.compress`` over every
snapshot with the traffic's ``keep`` and ``options``, each pass into a
fresh directory.  The check reads every member of every pass against the
reference's per-(box, field) threshold at one scale."""

from __future__ import annotations

import os
import shutil
import time

from wtbench.drivers import Base, sync
from wtbench.reference import archive as ref_archive
from wtbench.reference import check

LIMITS = {"missing_members": 0, "wrong_members": 0}


class Driver(Base):
    produces = "archive"

    def setup(self):
        opts = self.ctx.traffic.get("options", {})
        warm = os.path.join(self.ctx.work, "warm")
        # every box shape, at one field's batch sizes
        self.compress(warm, components=self.ds.components[:1], **opts)
        self.ctx.written += ref_archive.dir_bytes(warm)
        shutil.rmtree(warm)

    def window(self, seconds):
        opts = self.ctx.traffic.get("options", {})

        def one_pass(i):
            out = os.path.join(self.ctx.work, f"archive{i}")
            t0 = time.perf_counter()
            stats = self.compress(out, **opts)
            sync(self.ctx.device)
            wall = time.perf_counter() - t0
            nbytes = ref_archive.dir_bytes(out)
            self.ctx.written += nbytes
            return {"wall": wall, "stats": stats, "dir": out,
                    "f32_bytes": self.ds.f32_bytes(),
                    "items": sum(1 for _ in self.ds.items()),
                    "archive_bytes": nbytes}
        return self.passes(seconds, one_pass)

    def check(self, records):
        found = {p: ref_archive.members(r["dir"])
                 for p, r in enumerate(records)}
        numbers, bad = check.compare_compress(
            self.ds, self.keep, list(found),
            present=lambda p: found[p].keys(),
            payload_of=lambda p, k: ref_archive.decode(
                ref_archive.read(found[p][k])),
            device=self.ctx.device)
        return numbers, len(bad)


def control(ds, traffic, seed, device, dtype):
    keep = float(traffic.get("keep", 0.999))
    ctl = check.reference_payloads(ds, keep, device, dtype)
    numbers, _ = check.compare_compress(
        ds, keep, [0], present=lambda p: ctl.keys(),
        payload_of=lambda p, k: ctl[k], device=device)
    return numbers
