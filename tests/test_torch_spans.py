"""The port's spans and counters (``runtime/debug.span``).

A tiny dataset (two timesteps, two levels, boxes of five shapes, two
components) is compressed with ``device=cpu`` in both archive modes, on
the NumPy + ``lzma`` host codec (the one the packer's member counters
time), and regenerated with ``iter_decompressed_timesteps``.  The stats
must carry the device step's parts and the packer's counters, and the
parts must fit inside the stage that holds them.  Under ``torch.profiler``
the calling thread's spans appear, each inside its parent; with no
profiler, no profiler range is opened; and the profiler changes
no byte of the archive and no value of the regenerated boxes.
"""

import json
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import wavelet_tpu_torch  # noqa: E402
from wavelet_tpu_torch import cli  # noqa: E402
from wavelet_tpu_torch.io import plotfile  # noqa: E402
from wavelet_tpu_torch.pipeline import common  # noqa: E402
from wavelet_tpu_torch.pipeline.decompress import \
    iter_decompressed_timesteps  # noqa: E402
from wavelet_tpu_torch.runtime import debug  # noqa: E402
from wavelet_tpu_torch.runtime.debug import span  # noqa: E402

COMPS = ["density", "temp"]
MODES = ["files", "bundle"]
COMPRESS_KEYS = ("read_seconds", "device_seconds", "pack_wait_seconds",
                 "h2d_seconds", "launch_seconds", "d2h_seconds",
                 "threshold_seconds", "device_cpu_seconds", "pack_seconds",
                 "pack_cpu_seconds", "xz_in_bytes", "xz_cpu_seconds",
                 "close_seconds", "preprocess_seconds", "compress_seconds",
                 "free_seconds")
REGEN_KEYS = ("unpack_seconds", "device_seconds", "h2d_seconds",
              "launch_seconds", "d2h_seconds", "assemble_seconds",
              "device_cpu_seconds", "unpack_cpu_seconds", "xz_decoded_bytes",
              "xz_decode_cpu_seconds")
DEVICE_PARTS = ("h2d_seconds", "launch_seconds", "d2h_seconds",
                "threshold_seconds", "free_seconds")
COMPRESS_SPANS = ("compress.setup", "compress.run", "compress.read",
                  "compress.device_step", "compress.pack_wait",
                  "compress.close", "engine.h2d", "engine.launch",
                  "engine.d2h", "engine.threshold", "engine.free")
REGEN_SPANS = ("decompress.unpack", "decompress.device_step",
               "decompress.assemble", "engine.h2d", "engine.launch",
               "engine.d2h")
PARENTS = {"compress.setup": None, "compress.run": None,
           "compress.read": "compress.run",
           "compress.device_step": "compress.run",
           "compress.pack_wait": "compress.run",
           "compress.close": "compress.run",
           "engine.threshold": "compress.device_step",
           "decompress.unpack": None, "decompress.device_step": None,
           "decompress.assemble": None}


def _write_data(root: str) -> str:
    rng = np.random.default_rng(5)
    data = os.path.join(root, "data")
    l0 = [((0, 0, 0), (8, 8, 8)), ((8, 0, 0), (8, 8, 8))]
    l1 = [((0, 0, 0), (7, 5, 3)), ((8, 0, 0), (8, 4, 2)),
          ((16, 0, 0), (16, 8, 8)), ((0, 8, 0), (9, 6, 5))]
    for t, name in enumerate(["plt00010", "plt00020"]):
        boxes = [[rng.standard_normal((2,) + d).astype(np.float32)
                  .cumsum(axis=1) for _, d in lev] for lev in (l0, l1)]
        plotfile.write_plotfile(
            os.path.join(data, name), boxes,
            [[loc for loc, _ in lev] for lev in (l0, l1)],
            [[d for _, d in lev] for lev in (l0, l1)],
            COMPS, 0.5 + t, [0.0, 0.0, 0.0], [1.0, 0.5, 0.5], (2, 2, 2),
            (16, 8, 8), [10 * (t + 1), 20 * (t + 1)])
    return data


def _compress(data, out, mode):
    return wavelet_tpu_torch.compress(
        data, out, min_time="plt00010", max_time="plt00020",
        components=COMPS, min_level=0, max_level=1, keep=0.999,
        device="cpu", archive=mode)


def _regen(archive):
    stats = {}
    boxes = {}
    cfg = common.Config(compressed_dir=archive, device="cpu")
    for t, _name, regen, *_ in iter_decompressed_timesteps(cfg, stats=stats):
        for lev, per in enumerate(regen):
            for b, arr in enumerate(per):
                boxes[(t, lev, b)] = arr
    return stats, boxes


def _tree(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def _events(prof, names):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name in names]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per mode: the compress stats, the archive's files and the regen
    stats and boxes, without and with the profiler (and its events)."""
    root = tmp_path_factory.mktemp("spans")
    data = _write_data(str(root))
    out = {}
    for mode in MODES:
        plain = str(root / f"{mode}_plain")
        traced = str(root / f"{mode}_traced")
        cstats = _compress(data, plain, mode)
        rstats, boxes = _regen(plain)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _compress(data, traced, mode)
            _, tboxes = _regen(traced)
        out[mode] = {"cstats": cstats, "rstats": rstats,
                     "tree": _tree(plain), "boxes": boxes,
                     "ttree": _tree(traced), "tboxes": tboxes,
                     "events": _events(prof, set(COMPRESS_SPANS)
                                       | set(REGEN_SPANS))}
    return out


@pytest.mark.parametrize("mode", MODES)
def test_compress_stats_have_the_span_keys(runs, mode):
    st = runs[mode]["cstats"]
    for k in COMPRESS_KEYS:
        assert st[k] > 0, k


@pytest.mark.parametrize("mode", MODES)
def test_regen_stats_have_the_span_keys(runs, mode):
    st = runs[mode]["rstats"]
    for k in REGEN_KEYS:
        assert st[k] > 0, k


@pytest.mark.parametrize("mode", MODES)
def test_device_parts_fit_the_device_step(runs, mode):
    cs, rs = runs[mode]["cstats"], runs[mode]["rstats"]
    assert sum(cs[k] for k in DEVICE_PARTS) <= cs["device_seconds"]
    assert (rs["h2d_seconds"] + rs["launch_seconds"] + rs["d2h_seconds"]
            + rs["free_seconds"] <= rs["device_seconds"])
    # the calling thread's CPU inside the step is part of its wall
    assert cs["device_cpu_seconds"] <= cs["device_seconds"] * 1.05 + 0.01


@pytest.mark.parametrize("mode", MODES)
def test_member_cpu_fits_the_pool(runs, mode):
    from wavelet_tpu_torch.runtime.engine import HostPacker

    workers = HostPacker().workers
    cs, rs = runs[mode]["cstats"], runs[mode]["rstats"]
    n = 2 * 6 * 2      # members: timesteps x boxes x components
    slack = 1e-3 * n    # thread-clock granularity, a member at a time
    assert cs["pack_cpu_seconds"] <= workers * cs["pack_seconds"] + slack
    assert cs["xz_cpu_seconds"] <= cs["pack_cpu_seconds"]
    assert (rs["xz_decode_cpu_seconds"] <= rs["unpack_cpu_seconds"]
            <= workers * rs["unpack_seconds"] + slack)


@pytest.mark.parametrize("mode", MODES)
def test_xz_bytes_in_equal_bytes_decoded(runs, mode):
    """The payload bytes the pack hands xz are the bytes the unpack gets
    back, member for member."""
    cs, rs = runs[mode]["cstats"], runs[mode]["rstats"]
    assert cs["xz_in_bytes"] == rs["xz_decoded_bytes"] > 0


@pytest.mark.parametrize("mode", MODES)
def test_profiler_changes_no_output(runs, mode):
    r = runs[mode]
    assert r["tree"].keys() == r["ttree"].keys()
    for name, blob in r["tree"].items():
        if name in ("runinfo.raw", "wtc-meta.json"):
            continue      # they name the run's own directories
        assert r["ttree"][name] == blob, name
    assert r["boxes"].keys() == r["tboxes"].keys()
    for k, arr in r["boxes"].items():
        assert np.array_equal(arr.view(np.uint32),
                              r["tboxes"][k].view(np.uint32)), k


@pytest.mark.parametrize("mode", MODES)
def test_calling_thread_spans_nest_under_the_profiler(runs, mode):
    ev = runs[mode]["events"]
    names = {n for n, _, _ in ev}
    assert set(COMPRESS_SPANS) | set(REGEN_SPANS) <= names

    def inside(child, parents):
        _, s, e = child
        return any(ps <= s and e <= pe for _, ps, pe in parents)

    by = {n: [x for x in ev if x[0] == n] for n in names}
    for name, parent in PARENTS.items():
        if parent is not None:
            assert all(inside(x, by[parent]) for x in by[name]), name
    steps = by["compress.device_step"] + by["decompress.device_step"]
    for part in ("engine.h2d", "engine.launch", "engine.d2h",
                 "engine.free"):
        assert all(inside(x, steps) for x in by[part]), part
    # a compress stage inside the whole compress call
    assert all(inside(x, by["compress.run"])
               for x in by["compress.device_step"])


def test_no_range_without_a_profiler(tmp_path, monkeypatch):
    entered = []

    class Counting:
        def __init__(self, *a, **k):
            entered.append(a)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counting)
    data = _write_data(str(tmp_path))
    stats = _compress(data, str(tmp_path / "a"), "bundle")
    _regen(str(tmp_path / "a"))
    assert stats["pack_cpu_seconds"] > 0
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with span("outer"):
            pass
    assert entered == [("outer", [])]


def test_default_packer_reports_the_codec_counters(tmp_path):
    """A ``HostPacker`` built with its defaults, nothing patched, packs and
    unpacks on the codec whose counters the benchmark reads: compress
    reports the workers' CPU and the xz bytes and seconds, and decompress
    the decode workers' CPU."""
    data = _write_data(str(tmp_path))
    arch, out = str(tmp_path / "a"), str(tmp_path / "o")
    st = wavelet_tpu_torch.compress(
        data, arch, min_time="plt00010", max_time="plt00020",
        components=COMPS, min_level=0, max_level=1, device="cpu")
    for key in ("pack_cpu_seconds", "xz_in_bytes", "xz_cpu_seconds"):
        assert st[key] > 0, key
    dst = wavelet_tpu_torch.decompress(arch, out, device="cpu")
    assert dst["unpack_cpu_seconds"] > 0
    assert dst["xz_decoded_bytes"] == st["xz_in_bytes"]


def test_span_nests_and_sums():
    sink = {}
    with span("a", sink, "a_seconds", cpu=True) as a:
        with span("b", sink, "b_seconds") as b:
            sum(range(10000))
        with span("b", sink, "b_seconds") as b2:
            pass
    assert (a.parent, b.parent, b2.parent) == (None, "a", "a")
    assert sink["b_seconds"] == pytest.approx(b.seconds + b2.seconds)
    assert sink["a_seconds"] == a.seconds >= sink["b_seconds"]
    assert sink["a_cpu_seconds"] == a.cpu_seconds > 0
    with span("c") as c:        # no sink: the handle alone
        pass
    assert c.parent is None and c.seconds >= 0 and c.cpu_seconds == 0.0


def test_phase_timer_keeps_its_log_line(caplog):
    sink = {}
    with caplog.at_level(logging.INFO, logger="wavelet_tpu_torch"):
        with debug.phase_timer("compress.run", nbytes=10**9,
                               message="Compression completed in %s "
                               "seconds.", sink=sink,
                               key="compress_seconds") as ph:
            pass
    assert sink["compress_seconds"] == ph.seconds
    line = caplog.records[-1].getMessage()
    assert line.startswith(f"Compression completed in {ph.seconds} seconds.")
    assert line.endswith("GB/s)")


def test_pack_thread_and_caller_share_one_stats_dict(tmp_path):
    """As in a compress run, a pack thread's packer (32 workers, more than
    the cores) and the calling thread's spans add to one stats dict, each
    to its own keys, under a short switch interval: no addition is lost."""
    import sys
    import threading

    from wavelet_tpu_torch.runtime import batching
    from wavelet_tpu_torch.runtime.engine import CodecEngine, HostPacker

    rng = np.random.default_rng(3)
    n = 64
    items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=i)
             for i in range(n)]
    data = rng.standard_normal((n, 8, 8, 8)).astype(np.float32)
    stats = {}
    eng = CodecEngine(device="cpu")
    cb, t32 = eng.compress_shapebatch(
        batching.ShapeBatch(shape=(8, 8, 8), data=data, items=items,
                            n_valid=n), 0.9)
    packer = HostPacker(workers=32, stats=stats, archive_format="bundle")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        th = threading.Thread(target=lambda: [
            packer.pack(str(tmp_path), cb, t32) for _ in range(4)])
        th.start()
        handles = []
        while th.is_alive() or len(handles) < 2000:
            with span("caller", stats, "caller_seconds") as s:
                pass
            handles.append(s.seconds)
        th.join(timeout=120)
        assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    packer.close_bundles()
    assert stats["caller_seconds"] == sum(handles)
    # four packs of the same members: four times one pack's payload bytes
    one = HostPacker(workers=1, archive_format="bundle")
    (tmp_path / "one").mkdir()
    one.pack(str(tmp_path / "one"), cb, t32)
    one.close_bundles()
    assert stats["xz_in_bytes"] == 4 * one.stats["xz_in_bytes"] > 0


def test_cli_profile_records_worker_spans(tmp_path, monkeypatch):
    """``profile=DIR`` traces every thread: the packer's member spans are
    in the Chrome trace beside the calling thread's."""
    data = _write_data(str(tmp_path))
    trace = tmp_path / "trace"
    rc = cli.main([f"datadir={data}", "minfile=plt00010",
                   "maxfile=plt00020", "minlevel=0", "maxlevel=1",
                   "components=density temp", "keep=0.999",
                   f"compresseddir={tmp_path / 'c'}/", "device=cpu",
                   f"profile={trace}", "-c"])
    assert rc in (0, None)
    events = json.loads((trace / "trace_p0.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"pack.member", "pack.xz", "pack.batch",
            "compress.device_step"} <= names
    tids = {e["tid"] for e in events if e.get("name") == "pack.member"}
    main = {e["tid"] for e in events if e.get("name") == "compress.run"}
    assert tids and not tids & main


GLOBAL_SPANS = ("compress.global_pass1", "compress.global_pass2")


@pytest.mark.parametrize("cache", ["cached", "reread"])
def test_global_mode_spans_and_counters(tmp_path, monkeypatch, cache):
    """``thresholdmode=global``: each pass is a span inside the whole call,
    holding its reads, device steps and pack waits; the counters say how
    many timesteps pass 2 took from the cache and how many it re-read.
    One process sums no histogram, so ``compress.allreduce`` is absent
    (the four-rank run of ``tests/test_wtbench_global4.py`` has it)."""
    data = _write_data(str(tmp_path))
    extra = {} if cache == "cached" else {"global_cache_bytes": 0}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st = wavelet_tpu_torch.compress(
            data, str(tmp_path / "a"), min_time="plt00010",
            max_time="plt00020", components=COMPS, min_level=0, max_level=1,
            threshold_mode="global", keep_fraction=0.05, device="cpu",
            **extra)
    cached = 2 if cache == "cached" else 0
    assert st["global_cached_timesteps"] == cached
    assert st["global_reread_timesteps"] == 2 - cached
    assert "allreduce_seconds" not in st
    p1, p2 = st["global_pass1_seconds"], st["global_pass2_seconds"]
    assert p1 > 0 and p2 > 0
    assert p1 + p2 <= st["compress_seconds"]
    # pass 2 holds every pack wait; the re-reads, when there are any
    assert st["pack_wait_seconds"] <= p2
    assert st["read_seconds"] <= p1 + p2
    ev = _events(prof, set(GLOBAL_SPANS) | {"compress.run",
                                            "compress.read"})
    by = {n: [(s, e) for m, s, e in ev if m == n] for n, _, _ in ev}
    assert len(by["compress.global_pass1"]) == 1
    assert len(by["compress.global_pass2"]) == 1
    (r0, r1), = by["compress.run"]
    for name in GLOBAL_SPANS:
        (s, e), = by[name]
        assert r0 <= s and e <= r1, name
    (s2, _), = by["compress.global_pass2"]
    rereads = [r for r in by["compress.read"] if r[0] >= s2]
    assert len(rereads) == 2 - cached
