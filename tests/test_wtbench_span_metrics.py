"""The benchmark's readers of the program's span keys (``wtbench/spans.py``,
``wtbench/metrics/*``): each gives its value on a synthetic run of two
passes, and None (the metric left out) on a run whose program reported no
such key, as a program without the spans reports none."""

import pytest

from wtbench import metrics
from wtbench.drivers import Run

GB = 1e9
# two passes of 0.5 GB of float32 boxes; each stat is the sum of the two
PASSES = [
    {"pack_seconds": 2.0, "pack_cpu_seconds": 12.0, "xz_in_bytes": 30e6,
     "xz_cpu_seconds": 10.0, "h2d_seconds": 0.1, "launch_seconds": 0.2,
     "d2h_seconds": 0.3, "threshold_seconds": 0.4,
     "device_cpu_seconds": 0.5, "unpack_seconds": 1.0,
     "unpack_cpu_seconds": 5.0, "xz_decoded_bytes": 40e6,
     "xz_decode_cpu_seconds": 2.0, "assemble_seconds": 0.05,
     "free_seconds": 0.25},
    {"pack_seconds": 2.0, "pack_cpu_seconds": 4.0, "xz_in_bytes": 10e6,
     "xz_cpu_seconds": 10.0, "h2d_seconds": 0.1, "launch_seconds": 0.2,
     "d2h_seconds": 0.3, "threshold_seconds": 0.4,
     "device_cpu_seconds": 0.5, "unpack_seconds": 1.0,
     "unpack_cpu_seconds": 3.0, "xz_decoded_bytes": 40e6,
     "xz_decode_cpu_seconds": 2.0, "assemble_seconds": 0.05,
     "free_seconds": 0.25},
]
EXPECTED = {
    "pack_cores.compress": 16.0 / 4.0,
    "pack_cores.bundle": 16.0 / 4.0,
    "xz_mb_per_core_s.compress": 40.0 / 20.0,
    "xz_mb_per_core_s.bundle": 40.0 / 20.0,
    "h2d_s_per_gb.bundle": 0.2,
    "launch_s_per_gb.bundle": 0.4,
    "d2h_s_per_gb.bundle": 0.6,
    "threshold_s_per_gb.bundle": 0.8,
    "device_step_cpu_s_per_gb.bundle": 1.0,
    "free_s_per_gb.bundle": 0.5,
    "unpack_cores.regen": 8.0 / 2.0,
    "xz_decode_mb_per_core_s.regen": 80.0 / 4.0,
    "h2d_s_per_gb.regen": 0.2,
    "d2h_s_per_gb.regen": 0.6,
    "assemble_s_per_gb.regen": 0.1,
}


def _run(stats_per_pass, produces="archive"):
    return Run(produces=produces, records=[
        {"wall": 10.0, "f32_bytes": 0.5 * GB, "items": 8, "stats": dict(st)}
        for st in stats_per_pass])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_value(name):
    assert metrics.load(name)(_run(PASSES)) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_absent_without_the_stat(name):
    """The parent program's stats: the stage times it had (among them
    ``unpack_cores.regen``'s denominator), none of the span keys."""
    old = [{"read_seconds": 1.0, "device_seconds": 1.0,
            "pack_wait_seconds": 3.0, "unpack_seconds": 1.0}] * 2
    assert metrics.load(name)(_run(old)) is None
    assert metrics.load(name)(_run([])) is None


def test_a_zero_denominator_reads_none():
    st = [dict(PASSES[0], pack_seconds=0.0, xz_cpu_seconds=0.0)]
    assert metrics.load("pack_cores.compress")(_run(st)) is None
    assert metrics.load("xz_mb_per_core_s.compress")(_run(st)) is None


def test_every_new_reader_is_in_the_benchmark():
    from wtbench import spec

    layer = {m["name"]: m for m in spec.Bench().doc["per_layer"]}
    for name in EXPECTED:
        m = layer[name]
        assert m["source"] == "program_span"
        assert len(m["workloads"]) == 1
        cell = m["workloads"][0]
        assert name in [x["name"] for x in spec.Bench().metrics(cell, True)]
