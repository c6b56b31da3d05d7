"""Multi-process runs of the port (``coordinator= processes= processid=``)
against one process and against the JAX package's two-process runs.

Two ``python -m wavelet_tpu_torch.cli ... device=cpu`` processes join a
gloo process group on localhost; each compresses its
``process_local_slice`` of the work items (global mode sums the two
histograms before the threshold) or decompresses its slice of the
timesteps.  Archives and plotfiles must be byte-identical to a
single-process run and to two ``wavelet_tpu.cli`` processes on
``jax.distributed``; bundle names carry the process index in both.
Every coordinated pair runs under one deadline that kills both
(``tests/conftest.drain_procs``).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from conftest import drain_procs, tree_bytes  # noqa: E402

from wavelet_tpu import cli as jcli  # noqa: E402
from wavelet_tpu.io import plotfile  # noqa: E402
import wavelet_tpu_torch  # noqa: E402
from wavelet_tpu_torch import cli  # noqa: E402
from wavelet_tpu_torch.io import bundle  # noqa: E402
from wavelet_tpu_torch.pipeline import compress  # noqa: E402
from wavelet_tpu_torch.runtime import mesh as mesh_lib  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY = sys.executable
COMPS = ["a", "b"]
DEADLINE_S = 240


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


def _run_pair(module: str, args, extra=()) -> list:
    """Two coordinated CLI processes of ``module``; -> their outputs."""
    port = _free_port()
    procs = [subprocess.Popen(
        [PY, "-m", module, *args, f"coordinator=127.0.0.1:{port}",
         "processes=2", f"processid={pid}", *extra],
        env=_env(module == "wavelet_tpu.cli"), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = drain_procs(procs, timeout=DEADLINE_S)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _write_data(root: str, n_times: int = 3) -> str:
    rng = np.random.default_rng(17)
    data = os.path.join(root, "data")
    l0 = [((0, 0, 0), (8, 8, 8)), ((8, 0, 0), (8, 8, 8)),
          ((16, 0, 0), (16, 8, 8)), ((0, 8, 0), (9, 6, 5))]
    for t in range(n_times):
        boxes = []
        for b, (_, d) in enumerate(l0):
            base = np.fromfunction(
                lambda i, j, k: np.sin(0.2 * (i + b)) + 0.1 * j - 0.05 * k,
                d).astype(np.float32)
            boxes.append(np.stack(
                [base, (base + 0.02 * rng.standard_normal(d)).astype(
                    np.float32)]))
        plotfile.write_plotfile(
            os.path.join(data, f"plt{20 + t:05d}"), [boxes],
            [[loc for loc, _ in l0]], [[d for _, d in l0]], COMPS, 1.0 + t,
            [0., 0., 0.], [1., 1., 1.], (2, 2, 2), (32, 16, 8), [20 + t])
    return data


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _write_data(str(tmp_path_factory.mktemp("torch_multiprocess")))


def _c_args(data, comp, extra=()):
    return [f"datadir={data}", "minfile=plt00020", "maxfile=plt00022",
            "minlevel=0", "maxlevel=0", "components=a b", "keep=0.999",
            f"compresseddir={comp}", *extra, "-c"]


VARIANTS = {
    "box": (),
    "global": ("thresholdmode=global", "keepfraction=0.05"),
    "global_scales2_bundle": ("thresholdmode=global", "keepfraction=0.05",
                              "scales=2", "archive=bundle"),
    "bundle": ("archive=bundle",),
    "sparse_devices2": ("transfer=sparse", "devices=2"),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_two_processes_compress_like_one_and_like_jax(data, tmp_path,
                                                      variant):
    extra = VARIANTS[variant]
    one = str(tmp_path / "one") + os.sep
    assert cli.main(_c_args(data, one, extra) + ["device=cpu"]) == 0
    two = str(tmp_path / "two") + os.sep
    outs = _run_pair("wavelet_tpu_torch.cli", _c_args(data, two, extra),
                     ["device=cpu"])
    jax_two = str(tmp_path / "jax_two") + os.sep
    _run_pair("wavelet_tpu.cli",
              _c_args(data, jax_two,
                      [e for e in extra if not e.startswith("devices=")]))
    want = tree_bytes(jax_two)
    if "archive=bundle" in extra:
        # each process writes its own bundle per timestep it touches
        names = bundle.list_bundles(two)
        assert any("-p0" in n for n in names), names
        assert any("-p1" in n for n in names), names
        bs_one, bs_two = bundle.BundleSet(one), bundle.BundleSet(two)
        assert set(bs_one.keys()) == set(bs_two.keys())
        for key in bs_one.keys():
            assert bs_one.blob(*key) == bs_two.blob(*key), key
    else:
        assert tree_bytes(one) == want
    assert tree_bytes(two) == want
    if "thresholdmode=global" in extra:
        for out in outs:
            assert "Global magnitude threshold" in out, out[-2000:]


def test_two_processes_decompress_like_one_and_like_jax(data, tmp_path):
    arch = str(tmp_path / "arch") + os.sep
    assert cli.main(_c_args(data, arch, ("scales=2",))
                    + ["device=cpu"]) == 0
    one = str(tmp_path / "one") + os.sep
    assert cli.main([f"compresseddir={arch}", f"out={one}", "device=cpu",
                     "-d"]) == 0
    two = str(tmp_path / "two") + os.sep
    _run_pair("wavelet_tpu_torch.cli",
              [f"compresseddir={arch}", f"out={two}", "device=cpu", "-d"])
    jax_two = str(tmp_path / "jax_two") + os.sep
    _run_pair("wavelet_tpu.cli",
              [f"compresseddir={arch}", f"out={jax_two}", "-d"])
    want = tree_bytes(jax_two)
    assert len(want) == 3 * 3
    assert tree_bytes(one) == want
    assert tree_bytes(two) == want


def test_two_processes_partial_decompress(data, tmp_path):
    """The process slice applies to the SELECTED timesteps."""
    arch = str(tmp_path / "arch") + os.sep
    assert cli.main(_c_args(data, arch) + ["device=cpu"]) == 0
    sel = ["minfile=plt00021", "maxfile=plt00022", "components=b"]
    one = str(tmp_path / "one") + os.sep
    wavelet_tpu_torch.decompress(arch, one, device="cpu",
                                 min_time="plt00021", max_time="plt00022",
                                 components=["b"])
    two = str(tmp_path / "two") + os.sep
    _run_pair("wavelet_tpu_torch.cli",
              [f"compresseddir={arch}", f"out={two}", *sel, "device=cpu",
               "-d"])
    assert sorted(os.listdir(two)) == ["plt00021", "plt00022"]
    assert tree_bytes(two) == tree_bytes(one)


_AR = """
import sys
import numpy as np
from wavelet_tpu_torch.core import threshold
from wavelet_tpu_torch.pipeline import compress
from wavelet_tpu_torch.runtime import mesh
mesh.init_distributed(sys.argv[1], 2, int(sys.argv[2]))
r = mesh.process_index()
h = np.arange(threshold.EXP_HIST_BINS, dtype=np.int64) * (r + 1)
h[::7] += (3 << 31) + r
got = compress._allreduce_histogram(h)
want = np.arange(threshold.EXP_HIST_BINS, dtype=np.int64) * 3
want[::7] += (6 << 31) + 1
assert got.dtype == np.int64 and (got == want).all(), got[::7][:4]
print("allreduce ok", mesh.process_count())
"""


def test_histogram_allreduce_is_exact_past_2_to_the_31():
    port = _free_port()
    procs = [subprocess.Popen(
        [PY, "-c", _AR, f"127.0.0.1:{port}", str(pid)], env=_env(False),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = drain_procs(procs, timeout=DEADLINE_S)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert "allreduce ok 2" in out, out


def test_process_local_slice_tiles_the_items(monkeypatch):
    for n in (0, 1, 7, 24, 100):
        for p in (1, 2, 3, 8):
            covered = []
            for i in range(p):
                monkeypatch.setattr(mesh_lib, "process_count", lambda: p)
                monkeypatch.setattr(mesh_lib, "process_index", lambda: i)
                covered.extend(range(n)[mesh_lib.process_local_slice(n)])
            assert covered == list(range(n))


def test_outside_a_group_there_is_one_process():
    assert mesh_lib.process_index() == 0
    assert mesh_lib.process_count() == 1
    assert mesh_lib.process_local_slice(5) == slice(0, 5)
    assert mesh_lib.local_cuda_index() == 0


def test_init_distributed_refuses_a_topology_without_a_coordinator():
    with pytest.raises(ValueError, match="require a coordinator"):
        mesh_lib.init_distributed(None, 2, 0)
    with pytest.raises(ValueError, match="requires processes=N"):
        mesh_lib.init_distributed("127.0.0.1:1", 2, None)
    with pytest.raises(ValueError, match="outside 0..1"):
        mesh_lib.init_distributed("127.0.0.1:1", 2, 2)


def test_cli_coordinator_without_topology_is_jax_s_error(caplog):
    assert cli.main(["compresseddir=x", "out=y", "device=cpu",
                     "coordinator=127.0.0.1:1", "-d"]) == 1
    assert ("coordinator= requires processes=N and processid=I"
            in caplog.text)


def test_estimate_refuses_several_processes(monkeypatch, data):
    monkeypatch.setattr(mesh_lib, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="runs single-process"):
        wavelet_tpu_torch.estimate(data, min_time="plt00020",
                                   components=COMPS, device="cpu")


def test_bundle_writer_names_carry_the_process_index(monkeypatch, tmp_path):
    from wavelet_tpu_torch.runtime import engine

    monkeypatch.setattr(mesh_lib, "process_index", lambda: 3)
    w = engine.HostPacker(archive_format="bundle")._writer(str(tmp_path), 7)
    assert os.path.basename(w.path) == bundle.bundle_name(7, 3, 0)
    assert "-p3" in os.path.basename(w.path)


@pytest.mark.parametrize("argv", [
    ["giantmesh=global", "-c"],
    ["giantmesh=global", "-d"],
    ["giantmesh=global", "-estimate"],
])
def test_cli_giantmesh_global_is_not_ported(argv):
    """``giantmesh=global`` parses into ``cfg.giant_mesh`` for every mode
    that takes it, as in the JAX CLI (the default is ``local``)."""
    base = ["datadir=x", "minfile=a", "maxfile=b", "minlevel=0",
            "maxlevel=0", "components=temp", "keep=0.9", "compresseddir=y",
            "out=z", "device=cpu"]
    _, cfg = cli.parse_argv(base + argv)
    _, jcfg = jcli.parse_argv(base[:-1] + argv)
    assert cfg.giant_mesh == jcfg.giant_mesh == "global"
    _, cfg = cli.parse_argv(base + argv[1:])
    assert cfg.giant_mesh == "local"


def test_allreduce_helper_sums_in_one_process_group(tmp_path):
    """A one-process group: the all-reduce is the identity and keeps
    int64 counts above 2**31."""
    import torch.distributed as dist

    port = _free_port()
    mesh_lib.init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        h = np.full(8, (5 << 31) + 3, np.int64)
        np.testing.assert_array_equal(compress._allreduce_histogram(h), h)
        assert mesh_lib.process_count() == 1
    finally:
        dist.destroy_process_group()
