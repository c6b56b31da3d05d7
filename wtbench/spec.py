"""``BENCHMARK.json`` and the files it names, found by name."""

from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Bench:
    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.doc = json.load(f)

    def _named(self, section: str, name: str) -> dict:
        for entry in self.doc[section]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no {section[:-1]} named {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        with open(os.path.join(self.root, self._named("configs", name)["file"])) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
            return json.load(f)

    def metrics(self, cell: str, trace: bool) -> list:
        """The metrics a cell reports: end-to-end without a trace, per-layer
        with one.  An end-to-end metric without ``workloads`` belongs to
        every cell, a per-layer one to every cell that reports the metric
        it ``moves``."""
        e2e = [m for m in self.doc["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.doc["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in moved
                                 else [])]
