"""The port runs where jax is not installed, as on the GPU machine, and it
imports nothing of the JAX package ``wavelet_tpu``.

A subprocess makes ``import jax`` fail (``sys.modules["jax"] = None``),
writes a tiny dataset with the port's own ``plotfile``, runs ``-c`` / ``-d``
with ``device=cpu`` (box thresholds dense and with ``transfer=sparse``, then
global thresholds on a 2-scale pyramid, decompressed with
``transfer=sparse``, then box and global thresholds on the lane-packed
route, ``WAVELET_TPU_LAYOUT=halves``), ``-estimate`` (scratch and
``fastestimate=1`` with ``devicemetrics=1``), ``-check`` and ``-info``,
imports and runs the measurement programs (``bench``, ``scripts.bench_e2e``,
``scripts.scaling_bench``, ``scripts.measure_baseline``) and the host
benches (``scripts.bench_ragged``, ``bench_quality``, ``bench_host_codec``,
``fuzz_campaign``, ``bench_plotfile_io``) at a tiny size, and reports
every module of jax or of ``wavelet_tpu`` that got loaded.  Each host
bench answers ``python -m ... --help``.  A fresh process that compresses
through ``wavelet_tpu_torch.api`` maps no shared object of ``native/``.  A source scan refuses any import of either in the port,
``chip_smoke.py`` and ``profile_runs.py``.
"""

import json
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import os, sys
sys.modules["jax"] = None          # any import of jax now raises ImportError
import numpy as np
import torch
torch.set_num_threads(2)
from wavelet_tpu_torch.io import plotfile
from wavelet_tpu_torch import cli

root = sys.argv[1]
rng = np.random.default_rng(0)
boxes = [[rng.standard_normal((2, 8, 4, 2)).astype(np.float32),
          rng.standard_normal((2, 3, 5, 7)).astype(np.float32),
          rng.standard_normal((2, 8, 8, 8)).astype(np.float32)]]
plotfile.write_plotfile(os.path.join(root, "data", "plt00001"), boxes,
                        [[(0, 0, 0), (8, 0, 0), (16, 0, 0)]],
                        [[(8, 4, 2), (3, 5, 7), (8, 8, 8)]],
                        ["a", "b"], 0.0, [0.0] * 3, [1.0] * 3, (2, 2, 2),
                        (24, 8, 8), [1])
c_args = [f"datadir={root}/data", "minfile=plt00001", "maxfile=plt00001",
          "minlevel=0", "maxlevel=0", "components=a b", "device=cpu", "-c"]
runs = [("arch", ["keep=0.999"], "dense"),
        ("arch_s", ["keep=0.999", "transfer=sparse"], "sparse"),
        ("arch2", ["thresholdmode=global", "keepfraction=0.1", "scales=2"],
         "sparse")]
for arch, keys, d_transfer in runs:
    assert cli.main(c_args[:-2] + keys + [f"compresseddir={root}/{arch}/"]
                    + c_args[-2:]) == 0
    assert cli.main([f"compresseddir={root}/{arch}/", f"out={root}/o_{arch}/",
                     f"transfer={d_transfer}", "device=cpu", "-d"]) == 0
    regen = plotfile.read_level(f"{root}/o_{arch}/plt00001", 0, [0, 1])
    assert [b.shape for b in regen.boxes] == [(2, 8, 4, 2), (2, 3, 5, 7),
                                              (2, 8, 8, 8)]
os.environ["WAVELET_TPU_LAYOUT"] = "halves"
for arch, keys in (("arch_h", ["keep=0.999"]),
                   ("arch_hg", ["thresholdmode=global", "keepfraction=0.1"])):
    assert cli.main(c_args[:-2] + keys + [f"compresseddir={root}/{arch}/"]
                    + c_args[-2:]) == 0
    assert cli.main([f"compresseddir={root}/{arch}/", f"out={root}/o_{arch}/",
                     "device=cpu", "-d"]) == 0
est = [c_args[0], c_args[1], c_args[3], c_args[5], "keep=0.99 0.999"]
assert cli.main(est + ["device=cpu", "-estimate"]) == 0
assert cli.main(est + ["fastestimate=1", "devicemetrics=1", "device=cpu",
                       "-estimate"]) == 0
assert cli.main([f"compresseddir={root}/arch_h/", "-check"]) == 0
assert cli.main([f"compresseddir={root}/arch_h/", "-info"]) == 0
from wavelet_tpu_torch import entry
entry.dryrun_multichip(2, device="cpu")
# the measurement programs
from wavelet_tpu_torch import bench
from wavelet_tpu_torch.scripts import (bench_e2e, measure_baseline,
                                       scaling_bench)
r = bench.measure("cpu", n=2, dim=8, reps=1, iters=1, large_n=1, large_dim=8)
assert r["extra"]["roundtrip_rmse"] >= 0
scaling_bench.run("cpu", 2, per_device_boxes=1, dim=4, iters=1, reps=1)
bench_e2e.smooth_spiky_boxes(1, 8, 0)
measure_baseline.spiky_plotfile(os.path.join(root, "spiky"), 1, 8)
from wavelet_tpu_torch.scripts import (bench_host_codec, bench_plotfile_io,
                                       bench_quality, bench_ragged,
                                       fuzz_campaign)
bench_ragged.route_geometry(bench_ragged.build_shapes()[0], "halves")
bench_quality.synth_dataset(os.path.join(root, "quality"), 1)
assert fuzz_campaign.main(["--device", "cpu", "--trials-per", "2", "--root",
                           root, "--out", os.path.join(root, "f.json")]) == 0
bench_host_codec.make_coeffs(2, 64, 0.1)
bench_plotfile_io.synth_level(1, 4, 1, 0)
loaded = sorted(m for m, mod in sys.modules.items()
                if mod is not None and (m.split(".")[0] in ("jax", "jaxlib",
                                                            "wavelet_tpu")))
print("LOADED", loaded)
"""


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp_path)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "LOADED []" in p.stdout, p.stdout


_MAPS_SCRIPT = r"""
import json, os, sys
import numpy as np
from wavelet_tpu_torch import api
from wavelet_tpu_torch.io import plotfile

root = sys.argv[1]
box = np.random.default_rng(0).standard_normal((1, 8, 8, 8))
plotfile.write_plotfile(os.path.join(root, "data", "plt00001"),
                        [[box.astype(np.float32)]], [[(0, 0, 0)]],
                        [[(8, 8, 8)]], ["a"], 0.0, [0.0] * 3, [1.0] * 3,
                        (2, 2, 2), (8, 8, 8), [1])
st = api.compress(os.path.join(root, "data"), os.path.join(root, "arch"),
                  min_time="plt00001", max_time="plt00001", components=["a"],
                  device="cpu")
assert st["files"] == 1, st
with open("/proc/self/maps") as f:
    print("MAPPED", json.dumps(sorted({line.split()[-1] for line in f
                                       if ".so" in line})))
"""


@pytest.mark.skipif(not os.path.exists("/proc/self/maps"),
                    reason="needs /proc/self/maps")
def test_port_compress_maps_no_native_codec(tmp_path):
    """A fresh process that imports ``wavelet_tpu_torch.api`` and runs a
    tiny CPU compress maps no shared object of the repository's C++ codec
    directory ``native/`` (the JAX package's): the port's host codec is
    NumPy and liblzma, the one the card's machine runs."""
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", _MAPS_SCRIPT, str(tmp_path)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    [line] = [ln for ln in p.stdout.splitlines() if ln.startswith("MAPPED")]
    native_dir = os.path.join(os.path.realpath(REPO), "native") + os.sep
    mapped = json.loads(line[len("MAPPED "):])
    assert any("torch" in m for m in mapped), mapped
    assert not [m for m in mapped
                if os.path.realpath(m).startswith(native_dir)], mapped


@pytest.mark.parametrize("name", ["bench_ragged", "bench_quality",
                                  "bench_host_codec", "fuzz_campaign",
                                  "bench_plotfile_io"])
def test_host_bench_help(name):
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-m",
                        f"wavelet_tpu_torch.scripts.{name}", "--help"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.startswith(
        f"usage: python -m wavelet_tpu_torch.scripts.{name}"), p.stdout
    assert "--device" in p.stdout and "--out" in p.stdout


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|wavelet_tpu)\b", re.M)
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py",
                                             "profile_runs.py")]
    for d, _, names in os.walk(os.path.join(REPO, "wavelet_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f
    assert pat.search("from wavelet_tpu.io import plotfile")
    assert pat.search("  import wavelet_tpu")
    assert not pat.search("from wavelet_tpu_torch.io import plotfile")
