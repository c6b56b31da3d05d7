"""The port's host benches against the JAX package's scripts, on the CPU.

``wavelet_tpu_torch.scripts.{bench_ragged, bench_quality, bench_host_codec,
fuzz_campaign, bench_plotfile_io}`` keep the JAX scripts' datasets, shape
lists and mutations; each is held here to the JAX script, loaded by path
as tests/test_ragged_plan.py loads it:

- ragged: the 44 shapes and the halves padding geometry are JAX's; a
  ragged dataset (odd shapes, both levels) goes through the port's CLI at
  ``device=cpu`` and through ``wavelet_tpu.cli`` on both layouts with
  byte-identical archives and plotfiles;
- quality: the dataset is JAX's byte for byte and both sweeps report
  JAX's metrics exactly;
- fuzz: ``mutate`` and every campaign's tally are JAX's at one seed, the
  JAX script running with its native codec off, as on the card's machine;
- host codec: the coefficients, the bundle and delta-filter byte counts
  are JAX's; a CPU run's JSON carries no device number;
- plotfile I/O: the level is JAX's and a read returns the bytes written.

Each program's ``main`` runs once at a small size with ``--device cpu`` and
leaves nothing under ``--root`` but what was there; without a card and
without ``--device cpu`` each raises before it writes anything.
"""

import contextlib
import functools
import importlib.util
import json
import os
import shutil
import tempfile
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from conftest import tree_bytes  # noqa: E402

from wavelet_tpu import cli as jcli  # noqa: E402
from wavelet_tpu import native as jnative  # noqa: E402
from wavelet_tpu.runtime import engine as jengine  # noqa: E402
from wavelet_tpu_torch import cli  # noqa: E402
from wavelet_tpu_torch.scripts import bench_host_codec  # noqa: E402
from wavelet_tpu_torch.scripts import bench_plotfile_io  # noqa: E402
from wavelet_tpu_torch.scripts import bench_quality  # noqa: E402
from wavelet_tpu_torch.scripts import bench_ragged  # noqa: E402
from wavelet_tpu_torch.scripts import fuzz_campaign  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAMS = {"bench_ragged": bench_ragged, "bench_quality": bench_quality,
            "bench_host_codec": bench_host_codec,
            "fuzz_campaign": fuzz_campaign,
            "bench_plotfile_io": bench_plotfile_io}


def _jax_script(name: str):
    """``scripts/<name>.py`` of the JAX package, loaded by path."""
    os.environ["WAVELET_TPU_CACHE"] = "0"
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _root_with_marker(tmp_path):
    root = tmp_path / "root"
    (root / "mine").mkdir(parents=True)
    (root / "mine" / "keep.txt").write_text("x")
    return root


def _root_untouched(root) -> bool:
    return (sorted(os.listdir(root)) == ["mine"]
            and (root / "mine" / "keep.txt").read_text() == "x"
            and os.listdir(root / "mine") == ["keep.txt"])


# ---- bench_ragged ----------------------------------------------------------

# small shapes of the 44 (odd edges, Z that packs and Z that does not, both
# levels), at most four boxes each: the CLI comparison's dataset
def _small_ragged():
    shapes, _ = bench_ragged.build_shapes()
    small = [s for s in shapes if int(np.prod(s[0])) <= 10240]
    return [(dims, min(count, 4), lev) for dims, count, lev in small]


def test_ragged_shapes_and_padding_are_jax_s():
    jscript = _jax_script("bench_ragged")
    shapes, total = bench_ragged.build_shapes()
    assert (shapes, total) == jscript.build_shapes()
    assert bench_ragged.padding_stats(shapes) == jscript.padding_stats(shapes)
    # --scale keeps every shape and both levels; 1.0 is the JAX list
    assert bench_ragged.scale_shapes(shapes, 1.0) == (shapes, total)
    cut, cut_bytes = bench_ragged.scale_shapes(shapes, 0.01)
    assert [d for d, _c, _l in cut] == [d for d, _c, _l in shapes]
    assert {lev for _d, _c, lev in cut} == {0, 1}
    assert min(c for _d, c, _l in cut) == 1 and cut_bytes < total // 20
    # the route that ran: the default pads nothing, halves is JAX's geometry
    auto_pad, auto_b = bench_ragged.route_geometry(shapes, "auto")
    assert auto_pad["padded_slots"] == auto_pad["real_slots"] == 773
    assert auto_b == {"per_timestep": 44, "packed": 0}
    halves_pad, halves_b = bench_ragged.route_geometry(shapes, "halves")
    assert halves_pad == jscript.padding_stats(shapes)
    assert halves_b == {"per_timestep": 44, "packed": sum(
        1 for r in halves_pad["per_shape"].values() if r["pack"] > 1)}
    assert halves_b["packed"] >= 10


@pytest.mark.parametrize("layout", ["auto", "halves"])
def test_ragged_cli_run_is_the_jax_cli_s(tmp_path, layout):
    """The JAX script's dataset writer and CLI keys (``codec=raw
    archive=bundle prefetch=1``; ``-d outprec=f32``): the port's CLI at
    ``device=cpu`` writes ``wavelet_tpu.cli``'s archive and plotfiles
    byte for byte, under ``WAVELET_TPU_LAYOUT=layout``."""
    shapes = _small_ragged()
    assert len(shapes) >= 8 and {lev for *_x, lev in shapes} == {0, 1}
    assert any(d % 2 for dims, *_x in shapes for d in dims)
    jscript = _jax_script("bench_ragged")
    bench_ragged.write_dataset(str(tmp_path / "data"), shapes)
    jscript.write_dataset(str(tmp_path / "jdata"), shapes)
    assert tree_bytes(tmp_path / "data") == tree_bytes(tmp_path / "jdata")
    keys = [f"datadir={tmp_path}/data", "minfile=plt00800",
            "maxfile=plt00801", "minlevel=0", "maxlevel=1", "components=f",
            "keep=0.999", "codec=raw", "archive=bundle", "prefetch=1"]
    with mock.patch.dict(os.environ, {"WAVELET_TPU_LAYOUT": layout}):
        for main, name, dev in ((cli.main, "t", ["device=cpu"]),
                                (jcli.main, "j", [])):
            assert main(keys + [f"compresseddir={tmp_path}/a_{name}/"]
                        + dev + ["-c"]) == 0
            assert main([f"compresseddir={tmp_path}/a_{name}/",
                         f"out={tmp_path}/o_{name}/", "prefetch=1",
                         "outprec=f32"] + dev + ["-d"]) == 0
    want = tree_bytes(tmp_path / "a_j")
    assert any(k.endswith(".wtb") for k in want)
    assert tree_bytes(tmp_path / "a_t") == want
    want = tree_bytes(tmp_path / "o_j")
    assert len(want) == 10 and tree_bytes(tmp_path / "o_t") == want


@pytest.mark.parametrize("mode", [[], ["--in-process"]])
def test_ragged_main_on_cpu(tmp_path, monkeypatch, mode):
    """``main`` at ``--device cpu`` on a small shape list, each CLI call in
    a fresh process or in this one: cold and warm ``-c`` and ``-d`` rows
    with launch counts (none on the CPU), the route's geometry, the opt-in
    e2e rows, and ``--root`` left as it was."""
    shapes = _small_ragged()[:6]
    monkeypatch.setattr(bench_ragged, "build_shapes",
                        lambda: (shapes, None))
    art = {"card": {"name": "x"}, "cube64": {v: {"e2e_measured_gbps": 0.5}
                                            for v in ("collected",
                                                      "streaming",
                                                      "decompress_streaming")}}
    (tmp_path / "e2e.json").write_text(json.dumps(art))
    root = _root_with_marker(tmp_path)
    out = tmp_path / "r.json"
    assert bench_ragged.main(["--device", "cpu", "--layout", "halves",
                              "--root", str(root), "--out", str(out),
                              "--e2e", str(tmp_path / "e2e.json"),
                              *mode]) == 0
    assert _root_untouched(root)
    assert os.environ.get("WAVELET_TPU_LAYOUT") != "halves"
    r = json.loads(out.read_text())
    assert r["card"] == "cpu" and r["compare_cpu"] is None
    assert r["in_process"] == bool(mode)
    assert r["n_shapes"] == 6 and r["buckets"]["per_timestep"] == 6
    assert r["route_padding"] == bench_ragged.padding_stats(shapes)
    for row in ("compress_cold", "compress_warm", "decompress_cold",
                "decompress_warm"):
        assert r[row]["wall_seconds"] > 0 and r[row]["e2e_gbps"] > 0
        assert not any(r[row]["launches"].values())
        assert r[row]["library_seconds"] is None
    assert r["uniform_e2e"]["cube64"]["streaming"] == 0.5


# ---- bench_quality ---------------------------------------------------------

def test_quality_dataset_and_sweeps_are_jax_s(tmp_path):
    jscript = _jax_script("bench_quality")
    bench_quality.synth_dataset(str(tmp_path / "t"), 4)
    jscript.synth_dataset(str(tmp_path / "j"), 4)
    want = tree_bytes(tmp_path / "j")
    assert len(want) >= 3 and tree_bytes(tmp_path / "t") == want
    got = bench_quality.run_sweeps(str(tmp_path / "t"), "cpu")
    assert got == jscript.run_sweeps(str(tmp_path / "j"))
    assert set(got["box_keep_sweep"]["keep_sweep"]) == {"0.99", "0.999",
                                                        "0.9999"}


def test_quality_main_on_cpu(tmp_path):
    """``main`` at two boxes: the at-scale run, the CPU subset, and the
    ``--recorded`` comparison against a file holding JAX's metrics for
    the same dataset (all equal) and against one that differs."""
    jscript = _jax_script("bench_quality")
    jscript.synth_dataset(str(tmp_path / "j"), 2)
    rec = {"at_scale_cpu_1GiB": {**jscript.run_sweeps(str(tmp_path / "j")),
                                 "wall_s": 1.0, "platform": "cpu",
                                 "n_boxes": 2, "dataset_bytes": 2 << 20}}
    (tmp_path / "rec.json").write_text(json.dumps(rec))
    root = _root_with_marker(tmp_path)
    out = tmp_path / "q.json"
    assert bench_quality.main(["--device", "cpu", "--n-boxes", "2",
                               "--subset-boxes", "1", "--root", str(root),
                               "--recorded", str(tmp_path / "rec.json"),
                               "--out", str(out)]) == 0
    assert _root_untouched(root)
    q = json.loads(out.read_text())
    assert q["card"] == "cpu" and q["at_scale"]["n_boxes"] == 2
    assert q["subset_cuda_vs_cpu"]["cuda"] is None
    assert q["subset_cuda_vs_cpu"]["all_metrics_identical"] is None
    assert q["recorded"]["all_equal"] and not q["recorded"]["differing"]
    assert len(q["recorded"]["metrics"]) == 3 * 4 + 3 * 6
    rec["at_scale_cpu_1GiB"]["box_keep_sweep"]["keep_sweep"]["0.99"][
        "compressed_size_pct"] += 1e-9
    (tmp_path / "rec.json").write_text(json.dumps(rec))
    cmp = bench_quality.compare_recorded(q["at_scale"],
                                         str(tmp_path / "rec.json"))
    assert cmp["differing"] == [
        "box_keep_sweep/keep_sweep/0.99/compressed_size_pct"]


# ---- fuzz_campaign ---------------------------------------------------------

def test_fuzz_mutations_are_jax_s():
    jscript = _jax_script("fuzz_campaign")
    blobs = [b"Header\n3.0\n1 2 3\n", bytes(range(256)) * 3, b"x"]
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(1000):
        blob = blobs[i % 3]
        assert fuzz_campaign.mutate(blob, r1) == jscript.mutate(blob, r2)


@contextlib.contextmanager
def _scratch_at(path, dir=None):
    """``tempfile.TemporaryDirectory`` at one fixed path: ``runinfo.raw``
    names the dataset's directory, so the sidecar campaign mutates the
    same bytes only where both runs work at the same path."""
    os.makedirs(path)
    try:
        yield str(path)
    finally:
        shutil.rmtree(path)


@pytest.mark.parametrize("campaign", ["plotfile", "members", "sidecars",
                                      "bundle"])
def test_fuzz_campaign_tally_is_jax_s(tmp_path, monkeypatch, campaign):
    jscript = _jax_script("fuzz_campaign")
    kw = {"device": "cpu"} if campaign == "sidecars" else {}
    root = tmp_path / "root"
    root.mkdir()
    monkeypatch.setattr(tempfile, "TemporaryDirectory", functools.partial(
        _scratch_at, tmp_path / "tmpscratch"))
    tally, jtally = {}, {}
    getattr(fuzz_campaign, f"campaign_{campaign}")(
        20, np.random.default_rng(20260819), tally, str(root), **kw)
    with monkeypatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        getattr(jscript, f"campaign_{campaign}")(
            20, np.random.default_rng(20260819), jtally)
    assert tally == jtally and tally
    assert all(v["trials"] == 20 for v in tally.values())
    assert os.listdir(tmp_path) == ["root"] and os.listdir(root) == []


def test_fuzz_main_on_cpu(tmp_path):
    root = _root_with_marker(tmp_path)
    out = tmp_path / "f.json"
    assert fuzz_campaign.main(["--device", "cpu", "--trials-per", "5",
                               "--root", str(root), "--out", str(out)]) == 0
    assert _root_untouched(root)
    f = json.loads(out.read_text())
    assert f["card"] == "cpu" and f["backend_disagreements"] == 0
    assert f["total_mutations"] == 5 * len(f["surfaces"]) == 5 * 13


# ---- bench_host_codec ------------------------------------------------------

def test_host_codec_coefficients_are_jax_s():
    jscript = _jax_script("bench_host_codec")
    for args in ((3, 512, 0.01), (2, 4096, 0.05, 9)):
        a, ta = bench_host_codec.make_coeffs(*args)
        b, tb = jscript.make_coeffs(*args)
        np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(ta, tb)


def test_host_codec_bundle_and_delta_bytes_are_jax_s(tmp_path, monkeypatch):
    """``bench_bundle_vs_files`` packs JAX's member bytes (recorded from
    JAX's ``HostPacker``), and ``bench_xz_delta`` writes JAX's byte
    counts from the port's ``CodecEngine.compress_batch_raw``."""
    jscript = _jax_script("bench_host_codec")
    packed = []
    real_pack = jengine.HostPacker.pack

    def pack(self, *args, **kw):
        packed.append((self.archive_format, real_pack(self, *args, **kw)))
        return packed[-1][1]

    monkeypatch.setattr(jengine.HostPacker, "pack", pack)
    j = jscript.bench_bundle_vs_files()
    t = bench_host_codec.bench_bundle_vs_files(root=str(tmp_path))
    assert {k: t[k] for k in ("items", "dims", "input_bytes")} == {
        k: j[k] for k in ("items", "dims", "input_bytes")}
    assert sorted(set(packed)) == [("bundle", t["bundle_member_bytes"]),
                                   ("files", t["files_member_bytes"])]
    assert t["bundle_container_bytes"] > t["bundle_member_bytes"]
    jd = jscript.bench_xz_delta()
    td = bench_host_codec.bench_xz_delta("cpu", root=str(tmp_path))
    for data in ("smooth", "random"):
        for codec in ("xz6", "xz6_delta8"):
            assert (td[data][codec]["output_bytes"]
                    == jd[data][codec]["output_bytes"]), (data, codec)
        assert td[data]["delta_size_ratio"] == jd[data]["delta_size_ratio"]
    assert os.listdir(tmp_path) == []


def test_host_codec_main_on_cpu_has_no_device_number(tmp_path):
    root, tmpfs = _root_with_marker(tmp_path), tmp_path / "tmpfs"
    tmpfs.mkdir()
    out = tmp_path / "h.json"
    assert bench_host_codec.main(
        ["--device", "cpu", "--n-items", "4", "--dim", "16", "--root",
         str(root), "--tmpfs", str(tmpfs), "--out", str(out)]) == 0
    assert _root_untouched(root) and os.listdir(tmpfs) == []
    h = json.loads(out.read_text())
    an = h["analysis"]
    # no device rate is one of the JAX script's TPU constants (95.0 GB/s
    # the device codec, 30.8 the scatter stage), and no text names a TPU
    # host; measured values are compared as numbers, not as substrings
    rates = {k: an.get(k) for k in (
        "device_compress_gbps", "device_scatter_stage_gbps")}
    for codec in ("codec=xz", "codec=raw"):
        rates[codec] = h["pipeline_e2e"][codec]["e2e_input_gbps"]
    for k, v in rates.items():
        assert v not in (95.0, 30.8), (k, v)

    def strings(v):
        if isinstance(v, str):
            yield v
        elif isinstance(v, dict):
            for k, x in v.items():
                yield k
                yield from strings(x)
        elif isinstance(v, list):
            for x in v:
                yield from strings(x)

    for s in strings(h):
        assert "v5e" not in s and "vCPU" not in s, s
    assert h["card"] == "cpu"
    assert h["pipeline_e2e"]["boxes"] == 3
    assert h["bundle_vs_files"]["items"] == 128
    assert h["python_pack"]["kept=0.01"]["input_gbps_1thread"] > 0
    assert h["xz_delta"]["smooth"]["xz6"]["output_bytes"] > 0
    assert an == {"device_compress_gbps": None,
                  "device_scatter_stage_gbps": None, "device_card": None}
    assert bench_host_codec.analysis(
        {"card": "c", "pipeline_device_stage_gbps": 9.0,
         "sparse_scatter_stage_gbps": 0.1}) == {
        "device_compress_gbps": 9.0, "device_scatter_stage_gbps": 0.1,
        "device_card": "c"}


# ---- bench_plotfile_io -----------------------------------------------------

def test_plotfile_io_level_and_read_are_jax_s(tmp_path):
    jscript = _jax_script("bench_plotfile_io")
    for args in ((3, 8, 2, 64), (1, 16, 1, 128)):
        got, want = bench_plotfile_io.synth_level(*args), \
            jscript.synth_level(*args)
        assert got[1:] == want[1:]
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    root = _root_with_marker(tmp_path)
    out = tmp_path / "p.json"
    assert bench_plotfile_io.main(["--device", "cpu", "--n-scale", "0.02",
                                   "--root", str(root), "--out",
                                   str(out)]) == 0
    assert _root_untouched(root)
    p = json.loads(out.read_text())
    assert p["card"] == "cpu" and sorted(p["cases"]) == ["128^3_x1",
                                                         "64^3_x1"]
    for case in p["cases"].values():
        for prec in ("f64", "f32"):
            assert (case[f"read_{prec}"]["f32_bytes"]
                    == case[f"write_{prec}"]["src_bytes"])


# ---- every program ---------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_programs_without_a_card_raise_before_writing(tmp_path, name):
    """The default device is the card: without one, ``main`` raises (the
    process exits non-zero) before it makes a directory or an artifact."""
    assert not torch.cuda.is_available()
    root = _root_with_marker(tmp_path)
    out = tmp_path / "out.json"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        PROGRAMS[name].main(["--root", str(root), "--out", str(out)])
    assert _root_untouched(root) and not out.exists()
