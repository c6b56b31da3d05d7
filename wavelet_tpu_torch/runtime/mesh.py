"""Device lists and the process group: the port's counterpart of
``wavelet_tpu/runtime/mesh.py``.

A mesh is an ordered list of ``torch.device`` entries with one ``data``
axis: :class:`~wavelet_tpu_torch.runtime.engine.CodecEngine` splits each
batch into ``mesh.size`` contiguous row chunks, one per entry, and runs a
giant box's X-slabs one per entry.  Entries may repeat (two entries of
``cuda:0`` run both chunks on one card), which is how the tests and
``chip_smoke.py`` drive the mesh code on one device.

Multi-process runs use ``torch.distributed`` on the gloo backend: every
collective of the pipelines carries host data (the int64 magnitude
histogram), and gloo, unlike NCCL, takes two ranks on one GPU.  Each
process works on ``cuda:(rank % torch.cuda.device_count())``
(:func:`local_cuda_index`) and owns :func:`process_local_slice` of the
work items.
"""

from __future__ import annotations

import torch

__all__ = ["DATA_AXIS", "DeviceMesh", "data_mesh", "init_distributed",
           "process_index", "process_count", "process_local_slice",
           "local_cuda_index", "resolve_device"]

DATA_AXIS = "data"


def resolve_device(device) -> torch.device:
    """``"cuda"`` / ``"cpu"`` / a ``torch.device`` -> a usable device.
    ``cuda`` without a CUDA runtime raises: the port never runs a
    CUDA-requested job on the CPU."""
    try:
        dev = torch.device(device)
    except RuntimeError as e:
        raise ValueError(f"unsupported device {device!r} (cuda|cpu)") from e
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device=cuda requested but "
                               "torch.cuda.is_available() is false")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise ValueError(f"{dev} does not exist: "
                             f"{torch.cuda.device_count()} device(s)")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda|cpu)")
    return dev


class DeviceMesh:
    """An ordered device list along :data:`DATA_AXIS` (repeats allowed)."""

    def __init__(self, devices):
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in self.devices}) > 1:
            raise ValueError(f"mesh mixes device types: {self.devices}")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"DeviceMesh({[str(d) for d in self.devices]})"


def data_mesh(devices=None) -> DeviceMesh:
    """Mesh over the given devices, or over every CUDA device."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return DeviceMesh(devices)


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def init_distributed(coordinator: str | None, num_processes: int | None,
                     process_id: int | None) -> None:
    """Join the gloo process group at ``coordinator`` (``host:port``) as
    rank ``process_id`` of ``num_processes``.

    A topology given without a coordinator is refused, as in the JAX
    package: the port never reads its topology from the environment, so
    a missing address is an error, not a silently different group."""
    import torch.distributed as dist

    if coordinator is None:
        raise ValueError(
            "num_processes/process_id require a coordinator address "
            "(coordinator=host:port)")
    if num_processes is None or process_id is None:
        raise ValueError("coordinator= requires processes=N and "
                         "processid=I")
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"processid={process_id} is outside "
                         f"0..{int(num_processes) - 1}")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def process_index() -> int:
    d = _dist()
    return d.get_rank() if d else 0


def process_count() -> int:
    d = _dist()
    return d.get_world_size() if d else 1


def local_cuda_index() -> int:
    """The card this process works on: its rank modulo the card count."""
    return process_index() % max(1, torch.cuda.device_count())


def process_local_slice(n: int) -> slice:
    """This process's contiguous share of ``n`` work items."""
    p = process_count()
    i = process_index()
    per = -(-n // p)
    return slice(i * per, min(n, (i + 1) * per))
