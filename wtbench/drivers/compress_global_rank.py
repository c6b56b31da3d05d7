"""One rank of the ``compress_global`` driver, a rank other than 0::

    python3 -m wtbench.drivers.compress_global_rank '<JSON plan>'

It joins the program's gloo group (``runtime/mesh.init_distributed``) at
the plan's address as the plan's rank, then serves rank 0's passes until
rank 0 says stop: each pass it takes the pass's archive directory from
rank 0's broadcast, compresses its share of the run into it through
``wavelet_tpu_torch.compress`` on its card, meets the others at a barrier
and sends rank 0 its stats.  Rank 0, the harness process, runs the same
steps in ``compress_global.Driver``.

It never outlives its deadline: a timer ends the process at the plan's
``deadline`` (seconds since the epoch), and every broadcast can move it.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time


def rank_device(base: str) -> str:
    """This rank's device: its local rank's card (``local_cuda_index``)
    where the run is on CUDA, else the CPU."""
    if not str(base).startswith("cuda"):
        return "cpu"
    import torch

    from wavelet_tpu_torch.runtime import mesh

    idx = mesh.local_cuda_index()
    torch.cuda.set_device(idx)
    return f"cuda:{idx}"


def compress_share(plan: dict, out_dir: str, device: str) -> dict:
    """This rank's share of one pass: the program's own call, which takes
    the rank's ``process_local_slice`` of the items and sums the ranks'
    histograms before the threshold."""
    import wavelet_tpu_torch

    return wavelet_tpu_torch.compress(
        plan["data_dir"], out_dir, min_time=plan["min_time"],
        max_time=plan["max_time"], components=plan["components"],
        min_level=0, max_level=plan["max_level"], keep=plan["keep"],
        threshold_mode=plan["threshold_mode"],
        keep_fraction=plan["keep_fraction"],
        scales=plan["scales"], device=device, **plan["options"])


def sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize(device)


class Deadline:
    """Ends the process with exit code 124 at ``at`` (epoch seconds);
    :meth:`move` sets a new one."""

    def __init__(self, at: float):
        self._timer = None
        self.move(at)

    def move(self, at: float) -> None:
        if self._timer is not None:
            self._timer.cancel()
        self._timer = threading.Timer(max(0.0, at - time.time()), self._end)
        self._timer.daemon = True
        self._timer.start()

    @staticmethod
    def _end() -> None:
        print("compress_global_rank: deadline passed; exiting",
              file=sys.stderr, flush=True)
        os._exit(124)


def main(argv=None) -> int:
    plan = json.loads((argv or sys.argv[1:])[0])
    deadline = Deadline(plan["deadline"])
    import torch.distributed as dist

    from wavelet_tpu_torch.runtime import mesh

    mesh.init_distributed(plan["coordinator"], plan["processes"],
                          plan["rank"])
    device = rank_device(plan["device"])
    while True:
        msg = [None]
        dist.broadcast_object_list(msg, src=0)
        if msg[0] is None:
            break
        deadline.move(msg[0]["deadline"])
        stats = compress_share(plan, msg[0]["dir"], device)
        sync(device)
        dist.barrier()
        dist.gather_object(stats, None, dst=0)
    mesh.leave_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
