"""The harness is driven by data: a configuration, a traffic mix and a
metric that a later change adds are found by name with no file of the
benchmark edited; and ``BENCHMARK.json`` keeps to its contract."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from wtbench import drivers, metrics, spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DOC = spec.Bench().doc


def _line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(os.path.join(ROOT, "wtbench"), tmp_path / "wtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read()
              for p in map(str, (tmp_path / "wtbench").rglob("*"))
              if os.path.isfile(p)}
    doc = json.loads(json.dumps(DOC))
    w = tmp_path / "wtbench"
    cfg = json.load(open(w / "configs" / "nyx_rank64.json"))
    cfg.update(cells=32, max_grid_size=16)
    json.dump(cfg, open(w / "configs" / "nyx_small.json", "w"))
    (w / "datagen" / "nyx_small.py").write_text(
        "from wtbench.datagen.nyx_rank64 import generate  # noqa: F401\n")
    # a new traffic kind: its driver, with its comparison, in a file of its own
    (w / "drivers" / "compress_one_field.py").write_text(
        "from wtbench.drivers import compress\n"
        "LIMITS = {**compress.LIMITS, 'passes_checked_short': 0}\n"
        "control = compress.control\n"
        "class Driver(compress.Driver):\n"
        "    def check(self, records):\n"
        "        numbers, bad = super().check(records)\n"
        "        return {**numbers, 'passes_checked_short': 0}, bad\n")
    (w / "traffic" / "compress_raw.json").write_text(json.dumps(
        {"kind": "compress_one_field", "why": "codec=raw archive=bundle",
         "keep": 0.999, "options": {"codec": "raw", "archive": "bundle"}}))
    (w / "metrics" / "members_per_s.py").write_text(
        "def read(run):\n"
        "    return run.total('items') / run.total('wall')\n")
    doc["configs"].append({"name": "nyx_small", "source": "https://sdrbench.github.io/",
                           "file": "wtbench/configs/nyx_small.json",
                           "reduced": ["cells", "max_grid_size"], "why": "a test"})
    doc["workloads"].append({"name": "nyx_small.compress_raw", "config": "nyx_small",
                             "traffic": "compress_raw", "chips": 1, "why": "a test"})
    for m in doc["end_to_end"]:
        if m["name"] in ("compress_gbps", "archive_ratio"):
            m["workloads"].append("nyx_small.compress_raw")
    doc["end_to_end"].append({"name": "members_per_s", "unit": "1/s",
                              "better": "higher", "bound": 0.05,
                              "source": "host_clock",
                              "workloads": ["nyx_small.compress_raw"]})
    json.dump(doc, open(tmp_path / "BENCHMARK.json", "w"))
    code = ("import json\nfrom wtbench import run, spec\n"
            "b = spec.Bench()\n"
            "r = run.execute(b, b.cell('nyx_small.compress_raw'), 5, 0.2, False, 'cpu')\n"
            "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ,
                              "PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}"})
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert "passes_checked_short" in r["checks"]
    assert set(r["metrics"]) == {"members_per_s", "compress_gbps",
                                 "archive_ratio", "setup_s"}
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


def test_benchmark_json_keys_and_names():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= len(DOC["paths"]) <= 16 and DOC["paths"] == ["wtbench"]
    assert len(DOC["command"]) <= 32 and all(_line(c) for c in DOC["command"])
    assert isinstance(DOC["run_seconds"], int) and 1 <= DOC["run_seconds"] <= 51
    names = []
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("wtbench/") and os.path.isfile(
            os.path.join(ROOT, c["file"]))
        assert os.path.isfile(os.path.join(ROOT, "wtbench", "datagen",
                                           c["name"] + ".py"))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert _line(c["source"]) and _line(c["why"])
        names.append(c["name"])
    cells = {}
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"]) and os.path.isfile(
            os.path.join(ROOT, "wtbench", "traffic", w["traffic"] + ".json"))
        mod = drivers.load(spec.Bench().traffic(w["traffic"])["kind"])
        assert mod.LIMITS and callable(mod.control) and mod.Driver.produces
        cells[w["name"]] = w
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    assert {w["config"] for w in cells.values()} == set(names)
    e2e = {}
    for m in DOC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = m
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    layers = set()
    for m in DOC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", list(cells))
        assert set(m["workloads"]) <= set(moved)
        layers.add(m["layer"])
    all_metrics = DOC["end_to_end"] + DOC["per_layer"]
    for m in all_metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
        assert metrics.load(m["name"])  # its reader exists
        if "_roofline" in m["name"]:
            assert m["unit"] == "%"
    every = names + list(cells) + [m["name"] for m in all_metrics]
    assert all(NAME.match(n) for n in every)
    assert len(set(names)) == len(names) and len(set(m["name"] for m in all_metrics)) == len(all_metrics)
    b = spec.Bench()
    for cell in cells:
        rep = [m["name"] for m in b.metrics(cell, False)]
        assert "setup_s" in rep and len(rep) >= 2, cell
        assert b.metrics(cell, True), cell


def test_check_fits_the_time_it_is_given():
    n = 24
    runs = 2 + 14 * n
    assert runs * (DOC["run_seconds"] + 60) + n * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", [m["name"] for m in DOC["per_layer"]])
def test_per_layer_reader_returns_nothing_without_a_trace(name):
    from wtbench.drivers import Run

    run = Run(produces="archive", records=[{"wall": 1.0, "f32_bytes": 1e9,
                                         "items": 1, "stats": {}}])
    v = metrics.load(name)(run)
    if "roofline" in name or "idle" in name:
        assert v is None
