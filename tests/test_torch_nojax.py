"""The port runs where jax is not installed, as on the GPU machine.

A subprocess makes ``import jax`` fail (``sys.modules["jax"] = None``),
imports ``wavelet_tpu_torch``, runs ``-c`` / ``-d`` on a tiny dataset with
``device=cpu``, and reports every jax-related module that got loaded.
"""

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
from wavelet_tpu.io import plotfile
from wavelet_tpu_torch import cli

root = sys.argv[1]
rng = np.random.default_rng(0)
boxes = [[rng.standard_normal((2, 8, 4, 2)).astype(np.float32),
          rng.standard_normal((2, 3, 5, 7)).astype(np.float32)]]
plotfile.write_plotfile(os.path.join(root, "data", "plt00001"), boxes,
                        [[(0, 0, 0), (8, 0, 0)]], [[(8, 4, 2), (3, 5, 7)]],
                        ["a", "b"], 0.0, [0.0] * 3, [1.0] * 3, (2, 2, 2),
                        (16, 8, 8), [1])
assert cli.main([f"datadir={root}/data", "minfile=plt00001",
                 "maxfile=plt00001", "minlevel=0", "maxlevel=0",
                 "components=a b", "keep=0.999",
                 f"compresseddir={root}/arch/", "device=cpu", "-c"]) == 0
assert cli.main([f"compresseddir={root}/arch/", f"out={root}/out/",
                 "device=cpu", "-d"]) == 0
regen = plotfile.read_level(f"{root}/out/plt00001", 0, [0, 1])
assert [b.shape for b in regen.boxes] == [(2, 8, 4, 2), (2, 3, 5, 7)]
loaded = sorted(m for m, mod in sys.modules.items()
                if mod is not None and (m.split(".")[0] in ("jax", "jaxlib")
                                        or m.startswith("wavelet_tpu.pipeline")
                                        or m.startswith("wavelet_tpu.runtime.engine")
                                        or m.startswith("wavelet_tpu.kernels")))
print("LOADED", loaded)
"""


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp_path)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "LOADED []" in p.stdout, p.stdout


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax|import jaxlib|from jaxlib|"
                     r"from wavelet_tpu\.(pipeline|kernels|cli|api)|"
                     r"from wavelet_tpu\.runtime\.engine|"
                     r"from wavelet_tpu\.core\.(haar|threshold))", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(REPO, "wavelet_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f
