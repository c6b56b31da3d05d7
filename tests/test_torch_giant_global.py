"""Giant boxes split across processes (``giantmesh=global``) and the card
choice of multi-process runs.

Two ``python -m wavelet_tpu_torch.cli ... devices=2 device=cpu
giantmesh=global`` processes join a gloo group on localhost: a global
mesh of four CPU entries, two per process.  Every process transforms
every giant box (its own X-slabs, the slab pyramids gathered over gloo)
and writes only the items and timesteps of its slice.  Archives and
plotfiles must be byte-identical to a one-process port run and to a
one-process ``wavelet_tpu`` run of the same seeded plotfiles
(``tests/test_multihost.py`` holds JAX's two-process runs equal to its
one-process runs): box mode with a resumed rerun and ``-d``, global
thresholds with a ``globalcache`` that holds one of two timesteps, and
more processes than timesteps.  The split transform itself is held
bitwise to the one-process split in two gloo processes, unequal entry
counts are refused, and a group left up is torn down at exit.  Every
coordinated pair runs under one deadline that kills both
(``tests/conftest.drain_procs``).

The card rules run on monkeypatched host names and card counts: a
process's local rank is the number of lower ranks on its host;
``devices=N`` takes its host's cards ``local rank * N + i`` and refuses
cards the host lacks; the current device is the mesh's first card; and
without ``devices=`` a multi-process run splits giant boxes over the
process's share of its host's cards.
"""

import logging
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from conftest import drain_procs, tree_bytes  # noqa: E402

from wavelet_tpu.io import plotfile  # noqa: E402
from wavelet_tpu_torch import cli  # noqa: E402
from wavelet_tpu_torch.runtime import engine  # noqa: E402
from wavelet_tpu_torch.runtime import mesh as mesh_lib  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY = sys.executable
DEADLINE_S = 240
GLOBAL2 = ["giantmesh=global", "devices=2", "device=cpu"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(jax_side: bool) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    if jax_side:
        env.update(JAX_PLATFORMS="cpu", WAVELET_TPU_PLATFORM="cpu")
    return env


def _run(module: str, args) -> str:
    r = subprocess.run([PY, "-m", module, *args], env=_env(
        module == "wavelet_tpu.cli"), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=DEADLINE_S)
    assert r.returncode == 0, r.stdout[-3000:]
    return r.stdout


def _run_pair(args, script=None) -> list:
    """Two coordinated processes of the port's CLI (or of ``script``,
    given the address and the rank) -> their outputs."""
    port = _free_port()
    if script is None:
        cmds = [[PY, "-m", "wavelet_tpu_torch.cli", *args,
                 f"coordinator=127.0.0.1:{port}", "processes=2",
                 f"processid={pid}"] for pid in range(2)]
    else:
        cmds = [[PY, "-c", script, f"127.0.0.1:{port}", str(pid), *args]
                for pid in range(2)]
    procs = [subprocess.Popen(c, env=_env(False), cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    outs = drain_procs(procs, timeout=DEADLINE_S)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _write_data(root, steps, seed) -> str:
    """One giant (16, 8, 8) box and one (4, 4, 2) box per timestep, one
    component: giant at ``giantbox=2048``, and a batch that mixes the two
    processes' items."""
    rng = np.random.default_rng(seed)
    data = os.path.join(root, "data")
    for t in steps:
        boxes = [rng.standard_normal((1, 16, 8, 8)).astype(np.float32),
                 rng.standard_normal((1, 4, 4, 2)).astype(np.float32)]
        plotfile.write_plotfile(
            os.path.join(data, f"plt000{t}"), [boxes],
            [[(0, 0, 0), (16, 0, 0)]], [[(16, 8, 8), (4, 4, 2)]], ["a"],
            0.5 * t, [0., 0., 0.], [1., 1., 1.], (2, 2, 2), (32, 8, 8), [t])
    return data


def _c_args(data, steps, comp, extra=()):
    return [f"datadir={data}", f"minfile=plt000{steps[0]}",
            f"maxfile=plt000{steps[-1]}", "minlevel=0", "maxlevel=0",
            "components=a", "keep=0.999", "giantbox=2048",
            f"compresseddir={comp}", *extra, "-c"]


@pytest.mark.parametrize("scales", [1, 2])
def test_box_mode_resume_and_decompress(tmp_path, scales):
    steps = (40, 41)
    data = _write_data(str(tmp_path), steps, 47)
    keys = [f"scales={scales}"]
    jax_dir = str(tmp_path / "jax") + os.sep
    _run("wavelet_tpu.cli", _c_args(data, steps, jax_dir, keys))
    one = str(tmp_path / "one") + os.sep
    _run("wavelet_tpu_torch.cli", _c_args(data, steps, one,
                                           keys + ["device=cpu"]))
    two = str(tmp_path / "two") + os.sep
    outs = _run_pair(_c_args(data, steps, two, keys + GLOBAL2))
    for out in outs:
        assert "giantmesh=global" in out, out[-2500:]
        assert "Giant box path" in out, out[-2500:]
    want = tree_bytes(jax_dir)
    assert len(want) > 5
    assert tree_bytes(one) == want
    assert tree_bytes(two) == want
    # resume: the collective giant items are recomputed and rewritten
    # with the same bytes, the owned small items skipped
    outs = _run_pair(_c_args(data, steps, two,
                             keys + GLOBAL2 + ["resume=1"]))
    assert tree_bytes(two) == want
    assert any("Resume: skipped" in out for out in outs)
    # -d over the global mesh: each process decodes both timesteps and
    # writes its own
    j_out = str(tmp_path / "j_out") + os.sep
    _run("wavelet_tpu.cli", [f"compresseddir={jax_dir}", f"out={j_out}",
                             "-d"])
    t_out = str(tmp_path / "t_out") + os.sep
    outs = _run_pair([f"compresseddir={two}", f"out={t_out}", "giantbox=2048",
                      *GLOBAL2, "-d"])
    for out in outs:
        assert "giantmesh=global" in out, out[-2500:]
    assert sorted(os.listdir(t_out)) == ["plt00040", "plt00041"]
    assert tree_bytes(t_out) == tree_bytes(j_out)
    o_out = str(tmp_path / "o_out") + os.sep
    _run("wavelet_tpu_torch.cli", [f"compresseddir={one}", f"out={o_out}",
                                   "device=cpu", "-d"])
    assert tree_bytes(o_out) == tree_bytes(j_out)


def test_global_threshold_with_a_cache_of_one_timestep(tmp_path):
    """thresholdmode=global: the giant histogram is an all-reduce that
    every process launches for every giant item (only the owner counts
    it), and the globalcache admission comes from the timestep's size
    over every process; a 5000-byte budget caches timestep 0 (4224 bytes)
    and re-reads timestep 1, so both pass-2 branches run collectives."""
    steps = (60, 61)
    data = _write_data(str(tmp_path), steps, 53)
    keys = ["thresholdmode=global", "keepfraction=0.05", "globalcache=5000"]
    jax_dir = str(tmp_path / "jax") + os.sep
    _run("wavelet_tpu.cli", _c_args(data, steps, jax_dir, keys))
    one = str(tmp_path / "one") + os.sep
    out_one = _run("wavelet_tpu_torch.cli",
                   _c_args(data, steps, one, keys + ["device=cpu"]))
    assert "retained 1/2" in out_one
    two = str(tmp_path / "two") + os.sep
    outs = _run_pair(_c_args(data, steps, two, keys + GLOBAL2))
    for out in outs:
        assert "Giant box path (global threshold)" in out, out[-2500:]
        assert "retained 1/2" in out, out[-2500:]
    want = tree_bytes(jax_dir)
    assert tree_bytes(one) == want
    assert tree_bytes(two) == want


def test_decompress_with_more_processes_than_timesteps(tmp_path):
    """One timestep, two processes: process 1 owns nothing, decodes the
    timestep for the collective giant inverse, writes nothing and exits
    cleanly; the plotfile is written once, byte for byte the one-process
    runs'."""
    steps = (80,)
    data = _write_data(str(tmp_path), steps, 71)
    comp = str(tmp_path / "comp") + os.sep
    _run("wavelet_tpu.cli", _c_args(data, steps, comp))
    j_out = str(tmp_path / "j_out") + os.sep
    _run("wavelet_tpu.cli", [f"compresseddir={comp}", f"out={j_out}", "-d"])
    o_out = str(tmp_path / "o_out") + os.sep
    _run("wavelet_tpu_torch.cli", [f"compresseddir={comp}", f"out={o_out}",
                                   "device=cpu", "-d"])
    t_out = str(tmp_path / "t_out") + os.sep
    outs = _run_pair([f"compresseddir={comp}", f"out={t_out}",
                      "giantbox=2048", *GLOBAL2, "-d"])
    assert sorted(os.listdir(t_out)) == ["plt00080"]
    assert sum("plt00080" in out.split("giantmesh=global")[-1]
               for out in outs) == 1      # one process wrote it
    assert tree_bytes(t_out) == tree_bytes(j_out) == tree_bytes(o_out)


# ---- the split transform across two processes -----------------------------

_SPLIT = """
import sys
import numpy as np
import torch
from wavelet_tpu_torch.core import haar
from wavelet_tpu_torch.runtime import distributed, mesh
mesh.init_distributed(sys.argv[1], 2, int(sys.argv[2]))
gm = mesh.global_mesh(mesh.data_mesh(["cpu", "cpu"]))
assert (gm.size, gm.offset) == (4, 2 * mesh.process_index()), gm
one = mesh.data_mesh(["cpu"] * 4)
scales, X = 2, 32                     # 8 rows per entry, q = 4 divides 8
rng = np.random.default_rng(5)        # the same box in both processes
box = rng.standard_normal((X, 8, 16)).astype(np.float32)
box[3, 2, 1] = np.nan
bits = lambda a: np.asarray(a, np.float32).view(np.int32)
c, mx, mn = distributed.sharded_box_forward(gm, box, scales)
oc, omx, omn = distributed.sharded_box_forward(one, box, scales)
whole = haar.haar3d_forward_multi(torch.from_numpy(box[None]), scales)[0]
assert (bits(c) == bits(oc)).all() and (bits(c) == bits(whole)).all()
assert bits(mx) == bits(omx) and bits(mn) == bits(omn), (mx, omx, mn, omn)
back = distributed.sharded_box_inverse(gm, c, scales)
assert (bits(back) == bits(distributed.sharded_box_inverse(one, c,
                                                           scales))).all()
for fetch in (True, False):
    hc, h = distributed.sharded_box_forward_hist(gm, box, scales, fetch)
    ohc, oh = distributed.sharded_box_forward_hist(one, box, scales, fetch)
    assert (h == oh).all() and (hc is None) == (not fetch)
    assert hc is None or (bits(hc) == bits(ohc)).all()
local = distributed.giant_from_process_slabs(
    gm, box[16 * mesh.process_index():16 * mesh.process_index() + 16],
    box.shape)
assert [t.shape for t in local] == [(1, 8, 8, 16)] * 2
# the collective steps over the global mesh: each process gets its rows,
# and the thresholds, kept counts and RMSE of the whole batch
batch = rng.standard_normal((16, 4, 4, 8)).astype(np.float32)
batch[14:] = 0.0
rows = slice(8 * mesh.process_index(), 8 * mesh.process_index() + 8)
flat, signed = distributed.make_parity_compress_step(gm)(batch)
oflat, osigned = distributed.make_parity_compress_step(one)(batch)
assert (bits(flat) == bits(oflat[rows])).all()
assert (bits(signed) == bits(osigned[rows])).all()
masked, thr, kept = distributed.make_global_compress_step(gm, 0.1, 2)(batch)
om, othr, okept = distributed.make_global_compress_step(one, 0.1, 2)(batch)
assert (bits(masked) == bits(om[rows])).all() and bits(thr) == bits(othr)
assert (kept == okept).all(), (kept, okept)
recon, thr, rmse = distributed.make_train_step(gm, 0.25)(batch)
orecon, othr, ormse = distributed.make_train_step(one, 0.25)(batch)
assert (bits(recon) == bits(orecon[rows])).all() and bits(thr) == bits(othr)
assert np.isclose(rmse, ormse, rtol=1e-6), (rmse, ormse)
fwd = distributed.make_sharded_box_forward(gm)
assert (bits(fwd(box)) == bits(distributed.make_sharded_box_forward(one)(
    box))).all()
print("split ok", mesh.process_index(), distributed.gloo_bytes)
"""


def test_split_across_two_processes_is_the_one_process_split():
    outs = _run_pair([], script=_SPLIT)
    for pid, out in enumerate(outs):
        assert f"split ok {pid}" in out, out[-3000:]


_UNEQUAL = """
import sys
from wavelet_tpu_torch.runtime import mesh
mesh.init_distributed(sys.argv[1], 2, int(sys.argv[2]))
try:
    mesh.global_mesh(mesh.data_mesh(["cpu"] * (1 + mesh.process_index())))
except ValueError as e:
    print("refused:", e)
"""


def test_unequal_entry_counts_are_refused():
    outs = _run_pair([], script=_UNEQUAL)
    for out in outs:
        assert "refused: giantmesh=global needs the same number" in out, out
        assert "[1, 2]" in out


_NO_TEARDOWN = """
import sys
from wavelet_tpu_torch.runtime import mesh
mesh.init_distributed(sys.argv[1], 2, int(sys.argv[2]))
print("joined", mesh.process_index(), mesh.process_count())
"""


def test_a_group_left_up_is_torn_down_at_exit():
    """Both processes join and exit without tearing the group down: the
    teardown ``init_distributed`` registers at exit must end each cleanly
    (a live ProcessGroupGloo at interpreter shutdown can abort with
    ``terminate called without an active exception``)."""
    for _ in range(5):
        outs = _run_pair([], script=_NO_TEARDOWN)
        for pid, out in enumerate(outs):
            assert f"joined {pid} 2" in out, out[-3000:]
            assert "terminate called" not in out, out[-3000:]


def test_leave_distributed_twice_and_outside_a_group_does_nothing():
    import torch.distributed as dist

    mesh_lib.leave_distributed()              # no group: nothing to do
    mesh_lib.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    assert dist.is_initialized() and mesh_lib._teardown_registered
    mesh_lib.leave_distributed()
    assert not dist.is_initialized()
    mesh_lib.leave_distributed()              # the exit-time second call
    assert not dist.is_initialized()


def test_global_mesh_of_one_process_is_its_own_mesh():
    gm = mesh_lib.global_mesh(mesh_lib.data_mesh(["cpu"] * 3))
    assert (gm.size, gm.offset, gm.n_procs, gm.spans_processes) == (
        3, 0, 1, False)


# ---- card choice (C6) and the giant fallback (C5), monkeypatched ----------

def _cluster(monkeypatch, rank, hosts, cards):
    """This process as ``rank`` of a group laid out over ``hosts``, on a
    host with ``cards`` cards."""
    monkeypatch.setattr(mesh_lib, "_hosts", list(hosts))
    monkeypatch.setattr(mesh_lib, "process_index", lambda: rank)
    monkeypatch.setattr(mesh_lib, "process_count", lambda: len(hosts))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


TWO_BY_TWO = ["h0", "h0", "h1", "h1"]


@pytest.mark.parametrize("rank,local,cards2", [(0, 0, [0, 1]), (1, 1, [2, 3]),
                                               (2, 0, [0, 1]), (3, 1, [2, 3])])
def test_local_rank_picks_the_cards(monkeypatch, rank, local, cards2):
    _cluster(monkeypatch, rank, TWO_BY_TWO, 4)
    assert mesh_lib.local_rank() == local
    assert mesh_lib.local_process_count() == 2
    assert mesh_lib.local_cuda_index() == local
    assert [d.index for d in mesh_lib.local_cards(2)] == cards2
    assert [d.index for d in cli._mesh("cuda", 2).devices] == cards2
    if local:
        with pytest.raises(ValueError, match="this host has 4 card"):
            mesh_lib.local_cards(3)
    else:
        assert [d.index for d in mesh_lib.local_cards(4)] == [0, 1, 2, 3]


def test_local_rank_wraps_only_devices_1(monkeypatch):
    # three processes on a host of two cards: devices=1 shares cards ...
    _cluster(monkeypatch, 2, ["a", "a", "a"], 2)
    assert mesh_lib.local_cuda_index() == 0
    # ... devices=2 on local rank 2 would need cards 4 and 5
    with pytest.raises(ValueError, match="cuda:4..cuda:5"):
        mesh_lib.local_cards(2)


def test_init_distributed_learns_the_host_names(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(mesh_lib, "_hosts", [])
    monkeypatch.setattr(mesh_lib.socket, "gethostname", lambda: "node-7")
    mesh_lib.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        assert mesh_lib._hosts == ["node-7"]
        assert mesh_lib.local_rank() == 0
        assert mesh_lib.local_process_count() == 1
    finally:
        dist.destroy_process_group()


def test_cli_sets_the_current_device_to_the_mesh_s_first_card(monkeypatch,
                                                              tmp_path):
    _cluster(monkeypatch, 0, TWO_BY_TWO, 4)
    chosen = []

    def join(coordinator, n, i):
        assert (coordinator, n, i) == ("127.0.0.1:1", 4, 1)
        monkeypatch.setattr(mesh_lib, "process_index", lambda: i)

    monkeypatch.setattr(mesh_lib, "init_distributed", join)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    # rank 1, local rank 1: devices=2 is cuda:2 and cuda:3, the current
    # device cuda:2 (not the local rank's cuda:1); the run then fails on
    # the missing archive
    assert cli.main([f"compresseddir={tmp_path / 'none'}",
                     f"out={tmp_path / 'out'}", "coordinator=127.0.0.1:1",
                     "processes=4", "processid=1", "devices=2", "-d"]) == 1
    assert chosen == [torch.device("cuda", 2)]
    chosen.clear()
    assert cli.main([f"compresseddir={tmp_path / 'none'}",
                     f"out={tmp_path / 'out'}", "coordinator=127.0.0.1:1",
                     "processes=4", "processid=1", "-d"]) == 1
    assert chosen == [1]


GIANT = (64, 32, 32)     # 256 KiB: giant at giant_box_bytes=1 << 17


@pytest.mark.parametrize("rank,cards,want", [(3, 4, [2, 3]), (0, 4, [0, 1]),
                                             (1, 2, None)])
def test_multi_process_giant_boxes_take_the_process_s_cards(
        monkeypatch, caplog, rank, cards, want):
    """No devices=: JAX splits a giant box over jax.local_devices(); the
    port over this process's share of its host's cards (4 cards, 2
    processes a host: two each), and not at all on one card a process."""
    caplog.set_level(logging.INFO, logger="wavelet_tpu_torch")
    _cluster(monkeypatch, rank, TWO_BY_TWO, cards)
    eng = engine.CodecEngine(device="cuda", giant_box_bytes=1 << 17)
    for _ in range(3):
        assert eng.giant_ok(GIANT) == (want is not None)
    if want is None:
        assert eng._giant_mesh() is None
        return
    assert [d.index for d in eng._giant_mesh().devices] == want
    assert eng.pad_multiple_for(GIANT) == 1
    assert caplog.text.count("Giant boxes split over this process's") == 1


def test_one_process_without_a_mesh_splits_nothing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    eng = engine.CodecEngine(device="cuda", giant_box_bytes=1 << 17)
    assert eng._giant_mesh() is None and not eng.giant_ok(GIANT)
    assert not engine.CodecEngine(device="cpu", giant_box_bytes=1 << 17,
                                  giant_mesh_mode="global").giant_ok(GIANT)
    with pytest.raises(ValueError, match="giant mesh mode"):
        engine.CodecEngine(device="cpu", giant_mesh_mode="both")
