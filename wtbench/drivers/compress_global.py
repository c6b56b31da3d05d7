"""``compress_global``: one node's ranks compress a run to one global keep
fraction, pass after pass, each pass into a fresh directory that every
rank writes.

The traffic names the ranks (``processes``, one card each), the
``keep_fraction``, the ``scales`` and any further ``options`` of
``wavelet_tpu_torch.compress``.  Rank 0 is the harness process; set-up
starts ranks 1.. as ``compress_global_rank`` processes on localhost, joins
them in the program's gloo group (``runtime/mesh.init_distributed``) and
runs one warm-up pass.  A pass: rank 0 broadcasts its directory, every
rank compresses its share through the program's own call (its
``process_local_slice``; the ranks sum their magnitude histograms in one
gloo ``all_reduce`` before the threshold), a barrier, and rank 0 gathers
the ranks' stats.  A pass's wall runs from the broadcast to the barrier:
the slowest rank's.  Its record holds the whole node's box and archive
bytes, the ranks' stats summed (``stats``) and each rank's
(``rank_stats``).

No hang: each rank ends itself at a deadline, ``run_seconds`` + 60 s
after its start and then after the window's start; rank 0 watches the
ranks and, once one has exited before it was told to stop or the
deadline has passed, stops the rest, so that its own next collective
fails, and ends the process if it does not.  Rank 0 tells the ranks to
stop when the check begins, outside the window and its trace.

The check reads every member of every pass against
``reference.global_threshold`` and each rank's ``global_threshold``
against the reference's.
"""

from __future__ import annotations

import atexit
import concurrent.futures as cf
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

import numpy as np

from wtbench import spec
from wtbench.drivers import Base
from wtbench.drivers.compress_global_rank import (compress_share,
                                                  rank_device, sync)
from wtbench.reference import archive as ref_archive
from wtbench.reference import global_threshold

LIMITS = {"missing_members": 0, "wrong_members": 0, "threshold_mismatch": 0}
# after a rank has failed, how long rank 0 waits for its own collective to
# fail before it ends the process itself
GRACE_S = 20.0
# not summed over the ranks: the same number on every rank
SHARED_STATS = ("global_threshold",)
RANK_MODULE = "wtbench.drivers.compress_global_rank"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sum_stats(per_rank: list) -> dict:
    out = {}
    for st in per_rank:
        for k, v in st.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool) \
                    and k not in SHARED_STATS:
                out[k] = out.get(k, 0) + v
    return out


def _hist_calls() -> int:
    """The program's count of fused forward + histogram launches in this
    process (CUDA only)."""
    from wavelet_tpu_torch.kernels import pyramid_cuda

    return int(getattr(pyramid_cuda, "launches", {}).get("forward_hist", 0))


class Driver(Base):
    produces = "archive"

    def __init__(self, ctx):
        super().__init__(ctx)
        t = ctx.traffic
        self.n = int(t["processes"])
        self.keep_fraction = float(t["keep_fraction"])
        self.scales = int(t["scales"])
        self.limit_s = float(spec.Bench().doc["run_seconds"]) + 60.0
        self.procs = []
        self.logs = []
        self.deadline = 0.0
        self.fault = None
        self.stopped = threading.Event()
        self.device = None

    # -- the ranks ---------------------------------------------------------

    def _plan(self, port: int) -> dict:
        snaps = self.ds.snapshots
        return {"coordinator": f"127.0.0.1:{port}", "processes": self.n,
                "data_dir": self.ctx.data_dir, "min_time": snaps[0].name,
                "max_time": snaps[-1].name,
                "components": list(self.ds.components),
                "max_level": self.ds.n_levels - 1, "keep": self.keep,
                "threshold_mode": self.ctx.traffic["threshold_mode"],
                "keep_fraction": self.keep_fraction, "scales": self.scales,
                "options": self.ctx.traffic.get("options", {}),
                "device": self.ctx.device, "deadline": self.deadline}

    def _start_ranks(self, plan: dict) -> None:
        root = spec.ROOT
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        for r in range(1, self.n):
            log_path = os.path.join(self.ctx.work, f"rank{r}.log")
            with open(log_path, "wb") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", RANK_MODULE,
                     json.dumps({**plan, "rank": r})], cwd=root, env=env,
                    stdin=subprocess.DEVNULL, stdout=log,
                    stderr=subprocess.STDOUT))
            self.logs.append(log_path)
        atexit.register(self._kill)

    def _watch(self) -> None:
        """Rank 0's watchdog: a rank that exits before it is told to stop,
        or the deadline, stops every rank; rank 0's pending or next
        collective then fails.  If it does not within ``GRACE_S``, the
        process ends."""
        while not self.stopped.wait(0.2):
            if self._exited() or time.time() > self.deadline:
                break
        else:
            return
        self.fault = self._exited() or "the deadline passed"
        self._kill()
        if not self.stopped.wait(GRACE_S):
            print(f"compress_global: {self.fault}, and rank 0 is still "
                  f"blocked {GRACE_S:.0f} s later; ending the run.\n"
                  + self._log_tails(), file=sys.stderr, flush=True)
            os._exit(3)

    def _exited(self) -> str:
        """The ranks that have exited, with their exit codes ('' if none)."""
        dead = [f"rank {r} exited with code {p.returncode}"
                for r, p in enumerate(self.procs, 1) if p.poll() is not None]
        return "; ".join(dead)

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass

    def _log_tails(self, n: int = 2000) -> str:
        out = []
        for r, path in enumerate(self.logs, 1):
            try:
                with open(path, "rb") as f:
                    f.seek(max(0, os.path.getsize(path) - n))
                    out.append(f"--- rank {r} ---\n"
                               + f.read().decode(errors="replace"))
            except OSError:
                pass
        return "\n".join(out)

    def _failed(self, e: BaseException) -> RuntimeError:
        """The error that ends the run: which ranks exited (a rank's death
        reaches rank 0 as a gloo error, maybe before the rank is reaped),
        rank 0's own error, and the ranks' last output."""
        self.stopped.set()
        end = time.time() + 2.0
        while not self.fault and not self._exited() and time.time() < end:
            time.sleep(0.05)
        why = self.fault or self._exited()
        self._kill()
        return RuntimeError(f"compress_global: {why or 'rank 0 failed'}: "
                            f"{type(e).__name__}: {e}\n" + self._log_tails())

    def _teardown(self) -> None:
        """Tell the ranks to stop and leave the group; they exit on their
        own (:meth:`_reap` waits for them)."""
        import torch.distributed as dist

        from wavelet_tpu_torch.runtime import mesh

        self.stopped.set()
        try:
            if self.fault is None and all(p.poll() is None
                                          for p in self.procs):
                dist.broadcast_object_list([None], src=0)
        except RuntimeError:
            self._kill()
        finally:
            mesh.leave_distributed()

    def _reap(self) -> None:
        """Wait for the stopped ranks to exit; kill any still there."""
        end = time.time() + 30.0
        for p in self.procs:
            try:
                p.wait(timeout=max(0.0, end - time.time()))
            except subprocess.TimeoutExpired:
                pass
        self._kill()

    # -- a pass ------------------------------------------------------------

    def _pass(self, out: str) -> dict:
        import torch.distributed as dist

        t0 = time.perf_counter()
        dist.broadcast_object_list([{"dir": out, "deadline": self.deadline}],
                                   src=0)
        calls = _hist_calls()
        stats = compress_share(self.plan, out, self.device)
        sync(self.device)
        dist.barrier()
        wall = time.perf_counter() - t0
        calls = _hist_calls() - calls
        per_rank = [None] * self.n
        dist.gather_object(stats, per_rank, dst=0)
        nbytes = ref_archive.dir_bytes(out)
        self.ctx.written += nbytes
        return {"wall": wall, "stats": _sum_stats(per_rank),
                "rank_stats": per_rank, "dir": out,
                "f32_bytes": self.ds.f32_bytes(),
                "items": sum(1 for _ in self.ds.items()),
                "archive_bytes": nbytes, "scales": self.scales,
                "rank0_f32_bytes": stats["input_bytes"],
                "rank0_hist_calls": calls}

    def setup(self):
        from wavelet_tpu_torch.runtime import mesh

        port = _free_port()
        self.deadline = time.time() + self.limit_s
        self.plan = self._plan(port)
        self._start_ranks(self.plan)
        threading.Thread(target=self._watch, daemon=True).start()
        warm = os.path.join(self.ctx.work, "warm")
        try:
            mesh.init_distributed(self.plan["coordinator"], self.n, 0)
            self.device = rank_device(self.ctx.device)
            self._pass(warm)
        except Exception as e:
            err = self._failed(e)
            self._teardown()
            self._reap()
            raise err from e
        # _pass counted its bytes; the warm-up archive goes
        shutil.rmtree(warm)

    def window(self, seconds):
        self.deadline = time.time() + seconds + 60.0
        try:
            return self.passes(seconds, lambda i: self._pass(
                os.path.join(self.ctx.work, f"archive{i}")))
        except Exception as e:
            err = self._failed(e)
            self._teardown()
            self._reap()
            raise err from e

    def check(self, records):
        # the ranks stop here, outside the window and its trace, and exit
        # while the check runs
        self._teardown()
        t0 = time.perf_counter()
        try:
            thr, ref = global_threshold.reference(
                self.ds, self.keep_fraction, self.scales, self.ctx.device)
            t1 = time.perf_counter()
            found = {p: ref_archive.members(r["dir"])
                     for p, r in enumerate(records)}
            numbers, bad = compare(
                ref, list(found), present=lambda p: found[p].keys(),
                payload_of=lambda p, k: ref_archive.decode(
                    ref_archive.read(found[p][k])))
            t2 = time.perf_counter()
        finally:
            self._reap()
        print(f"compress_global: check: reference {t1 - t0:.3f} s, "
              f"{sum(map(len, found.values()))} members compared "
              f"{t2 - t1:.3f} s, ranks reaped {time.perf_counter() - t2:.3f}"
              " s", file=sys.stderr, flush=True)
        for p, r in enumerate(records):
            miss = sum(not same_float(st.get("global_threshold"), thr)
                       for st in r["rank_stats"])
            numbers["threshold_mismatch"] += miss
            if miss:
                bad.add(p)
        return numbers, len(bad)


def same_float(v, thr) -> bool:
    """``v`` (a rank's stat) is the float32 ``thr``, bit for bit."""
    if v is None:
        return False
    return np.float32(v).view(np.uint32) == np.float32(thr).view(np.uint32)


def compare(ref: dict, passes: list, present, payload_of, workers=None):
    """Every member of every pass against the reference's payloads
    ``ref``: ``present(p)`` the member keys of pass p, ``payload_of(p,
    key)`` a member's payload (one that cannot be read counts as wrong).
    -> (numbers, the passes at fault)."""
    expected = set(ref)

    def ok(job):
        p, key = job
        try:
            return payload_of(p, key) == ref[key]
        except (ValueError, OSError, EOFError, LookupError):
            return False

    missing = wrong = 0
    bad = set()
    # xz decodes outside the GIL: a thread a core
    with cf.ThreadPoolExecutor(workers or os.cpu_count() or 8) as pool:
        for p in passes:
            have = set(present(p))
            miss = len(expected ^ have)
            n_wrong = sum(not v for v in pool.map(
                ok, [(p, k) for k in sorted(expected & have)]))
            missing += miss
            wrong += n_wrong
            if miss or n_wrong:
                bad.add(p)
    return {"missing_members": missing, "wrong_members": wrong,
            "threshold_mismatch": 0}, bad


def control(ds, traffic, seed, device, dtype):
    """The reference at ``dtype`` in the ranks' place: its members and its
    threshold, on every rank, against the float32 reference's."""
    kf, scales = float(traffic["keep_fraction"]), int(traffic["scales"])
    thr, ref = global_threshold.reference(ds, kf, scales, device)
    ctl_thr, ctl = global_threshold.reference(ds, kf, scales, device, dtype)
    numbers, _ = compare(ref, [0], present=lambda p: ctl.keys(),
                         payload_of=lambda p, k: ctl[k])
    numbers["threshold_mismatch"] = int(traffic["processes"]) * int(
        not same_float(ctl_thr, thr))
    return numbers
