"""What BENCHMARK.json and the files under slambench/ say about a cell,
found by name: the cell's configuration file, its traffic file
(traffic/<traffic>.json), its limits (limits/<workload>.json) and each
metric's reader (metrics/<metric>.py).

A benchmark root holds BENCHMARK.json and may hold a slambench/ tree of
its own; a traffic, limits or reader file missing there is taken from the
harness's own folder.  So a cell, a traffic mix, a configuration or a
metric is added by adding files and entries, with no edit to a file that
is there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Spec:
    def __init__(self, root):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def _find(self, *parts) -> Path:
        """slambench/<parts> under the root, else in the harness's folder."""
        own = self.root / "slambench" / Path(*parts)
        return own if own.exists() else HERE / Path(*parts)

    def cell(self, workload: str) -> dict:
        """The workload's entry with its configuration and traffic loaded:
        {name, chips, config: dict, traffic: dict, limits: dict}."""
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                             f"(workloads: {', '.join(cells)})")
        w = cells[workload]
        cfg = next(c for c in self.bench["configs"] if c["name"] == w["config"])
        with open(self.root / cfg["file"]) as f:
            config = json.load(f)
        with open(self._find("traffic", f"{w['traffic']}.json")) as f:
            traffic = json.load(f)
        lim_path = self._find("limits", f"{workload}.json")
        limits = {}
        if lim_path.exists():
            with open(lim_path) as f:
                limits = json.load(f)
        return {"name": workload, "chips": int(w["chips"]), "config": config,
                "traffic": traffic, "limits": limits}

    def metrics(self, workload: str, traced: bool) -> list:
        """[(name, unit, reader)] of the cell: the end-to-end metrics, or
        with `traced` the per-layer ones, that list the cell or list none."""
        group = self.bench["per_layer" if traced else "end_to_end"]
        out = []
        for m in group:
            if "workloads" in m and workload not in m["workloads"]:
                continue
            out.append((m["name"], m["unit"], self.reader(m["name"])))
        return out

    def reader(self, name: str):
        """metrics/<name>.py's read(record) function."""
        path = self._find("metrics", f"{name}.py")
        module = "slambench_metric_" + name.replace(".", "_")
        spec = importlib.util.spec_from_file_location(module, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
