"""Device lists and the process group: the port's counterpart of
``wavelet_tpu/runtime/mesh.py``.

A mesh is an ordered list of ``torch.device`` entries with one ``data``
axis: :class:`~wavelet_tpu_torch.runtime.engine.CodecEngine` splits each
batch into ``mesh.size`` contiguous row chunks, one per entry
(:func:`batch_sharding`, :func:`shard_batch`), and runs a giant box's
X-slabs one per entry.  Entries may repeat (two entries of ``cuda:0`` run
both chunks on one card), which is how the tests and ``chip_smoke.py``
drive the mesh code on one device.

Multi-process runs use ``torch.distributed`` on the gloo backend: every
collective of the port carries host tensors (the int64 magnitude
histogram, a giant box's slab pyramids, the collective steps' sums), and
gloo, unlike NCCL, takes two ranks on one GPU.  :func:`init_distributed`
learns each rank's host name once, so a process knows its *local rank*
(the lower ranks on its host): it works on ``cuda:(local rank % cards)``
(:func:`local_cuda_index`), with ``devices=N`` on its host's cards
``local rank * N + i`` (:func:`local_cards`), and owns
:func:`process_local_slice` of the work items.  A :class:`GlobalMesh`
(:func:`global_mesh`) strings every process's entries together for
giant boxes split across processes (``giantmesh=global``).  A joined
group is torn down at exit (:func:`leave_distributed`).
"""

from __future__ import annotations

import atexit
import socket

import numpy as np
import torch

__all__ = ["DATA_AXIS", "DeviceMesh", "GlobalMesh", "data_mesh",
           "global_mesh", "batch_sharding", "shard_batch",
           "init_distributed", "leave_distributed", "process_index",
           "process_count", "process_local_slice", "local_rank",
           "local_process_count", "local_cuda_index", "local_cards",
           "process_group", "resolve_device"]

DATA_AXIS = "data"

# the host name of each rank of the current group, in rank order
# (init_distributed); empty outside a group
_hosts: list = []
# whether init_distributed has registered leave_distributed to run at exit
_teardown_registered = False


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
    """An ordered device list along :data:`DATA_AXIS` (repeats allowed),
    all of it in this process: entry k is ``devices[k]``."""

    offset = 0               # global index of devices[0]
    spans_processes = False

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


class GlobalMesh:
    """Every process's entries along :data:`DATA_AXIS`: ``n_procs``
    processes of ``n_local`` entries each, entry k in process ``k //
    n_local`` (the order of ``jax.devices()`` over a multi-process run).
    ``devices`` are this process's entries, global indices ``offset ..
    offset + n_local - 1``; process p holds rows ``[p*X/P, (p+1)*X/P)`` of
    a box split along X over the mesh.  Build it with
    :func:`global_mesh`."""

    def __init__(self, local: DeviceMesh, n_procs: int, rank: int):
        self.devices = local.devices
        self.n_local = local.size
        self.n_procs = int(n_procs)
        self.offset = int(rank) * self.n_local

    @property
    def size(self) -> int:
        return self.n_local * self.n_procs

    @property
    def spans_processes(self) -> bool:
        return self.n_procs > 1

    def __repr__(self) -> str:
        return (f"GlobalMesh({self.n_procs} processes x "
                f"{[str(d) for d in self.devices]})")


def data_mesh(devices=None) -> DeviceMesh:
    """Mesh over the given devices, or over every CUDA device."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return DeviceMesh(devices)


def global_mesh(local: DeviceMesh) -> GlobalMesh:
    """The mesh of every process's ``local`` entries.  Collective: every
    process of the group calls it at the same point (one gloo
    ``all_gather_object`` of the entry counts).  Unequal counts are
    refused, on every process alike: slab k of a box must belong to
    process ``k // n_local``."""
    counts = [local.size]
    if process_count() > 1:
        import torch.distributed as dist

        counts = [None] * process_count()
        dist.all_gather_object(counts, local.size)
    if len(set(counts)) > 1:
        raise ValueError(f"giantmesh=global needs the same number of mesh "
                         f"entries in every process; got {counts}, one "
                         "count per process")
    return GlobalMesh(local, len(counts), process_index())


def batch_sharding(n: int, mesh=None, device=None) -> list:
    """-> ``[(device, lo, hi)]``: this process's contiguous row chunks of an
    ``n``-row batch, one per mesh entry, in entry order.  Without a mesh,
    with one entry, or when a mesh of this process alone does not divide
    ``n``, the whole batch on ``device`` (default: the mesh's first
    entry), as the JAX package places a batch it cannot shard.  A mesh
    that spans processes must divide ``n``: each process holds its own
    rows only."""
    if mesh is None or mesh.size == 1 or (n % mesh.size
                                          and not mesh.spans_processes):
        dev = device if device is not None else (
            mesh.devices[0] if mesh is not None else resolve_device("cuda"))
        return [(dev, 0, n)]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over the {mesh.size} "
                         "entries of a mesh that spans processes")
    r = n // mesh.size
    return [(d, (mesh.offset + k) * r, (mesh.offset + k + 1) * r)
            for k, d in enumerate(mesh.devices)]


def shard_batch(x, mesh=None, device=None) -> list:
    """``x`` ``[N, ...]`` (numpy or a tensor) -> this process's row chunks
    as float32 tensors on their entries (:func:`batch_sharding`)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return [x[lo:hi].to(dev, torch.float32).contiguous()
            for dev, lo, hi in batch_sharding(x.shape[0], mesh, device)]


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def init_distributed(coordinator: str | None, num_processes: int | None,
                     process_id: int | None) -> None:
    """Join the gloo process group at ``coordinator`` (``host:port``) as
    rank ``process_id`` of ``num_processes``, then learn every rank's host
    name (one gloo ``all_gather_object``) for :func:`local_rank`.

    A topology given without a coordinator is refused, as in the JAX
    package: the port never reads its topology from the environment, so
    a missing address is an error, not a silently different group."""
    import torch.distributed as dist

    global _teardown_registered
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
    if not _teardown_registered:
        # a ProcessGroupGloo still alive at interpreter shutdown can abort
        # in its destructor ("terminate called without an active
        # exception"); jax.distributed.initialize registers its shutdown
        # the same way
        atexit.register(leave_distributed)
        _teardown_registered = True
    hosts = [None] * int(num_processes)
    dist.all_gather_object(hosts, socket.gethostname())
    _hosts[:] = hosts


def leave_distributed() -> None:
    """Tear down the process group if one is up; a second call, or a call
    outside a group, does nothing.  :func:`init_distributed` registers it
    to run at exit."""
    d = _dist()
    if d is not None:
        d.destroy_process_group()


def process_index() -> int:
    d = _dist()
    return d.get_rank() if d else 0


def process_count() -> int:
    d = _dist()
    return d.get_world_size() if d else 1


def process_group(mesh=None):
    """The group a step over ``mesh`` reduces over: the whole group when
    the mesh spans processes, else None (no collective)."""
    if mesh is None or not mesh.spans_processes:
        return None
    import torch.distributed as dist

    return dist.group.WORLD


def _rank_hosts():
    """Host name of each rank, or None when they are not known (no
    group, or one joined without :func:`init_distributed`): every rank
    then counts as on one host."""
    return _hosts if len(_hosts) == process_count() > 1 else None


def local_rank() -> int:
    """The number of lower ranks on this process's host."""
    r = process_index()
    hosts = _rank_hosts()
    if hosts is None:
        return r
    return sum(h == hosts[r] for h in hosts[:r])


def local_process_count() -> int:
    """The number of processes of the group on this process's host."""
    hosts = _rank_hosts()
    if hosts is None:
        return process_count()
    return hosts.count(hosts[process_index()])


def local_cuda_index() -> int:
    """The card this process works on: its local rank modulo the card
    count (processes beyond the cards share them)."""
    return local_rank() % max(1, torch.cuda.device_count())


def local_cards(n: int) -> list:
    """``devices=n`` of this process: its host's cards ``local_rank() * n
    + i`` for i < n.  Raises when they do not exist, never wrapping
    around onto another process's cards."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > have:
        # a truncated mesh would run the split program on fewer cards
        # than the user asked for
        raise ValueError(f"devices={n} but only {have} device(s) available")
    first = local_rank() * n
    if first + n > have:
        raise ValueError(
            f"devices={n} on local rank {local_rank()} needs "
            f"cuda:{first}..cuda:{first + n - 1}, but this host has {have} "
            "card(s)")
    return [torch.device("cuda", first + i) for i in range(n)]


def process_local_slice(n: int) -> slice:
    """This process's contiguous share of ``n`` work items."""
    p = process_count()
    i = process_index()
    per = -(-n // p)
    return slice(i * per, min(n, (i + 1) * per))
