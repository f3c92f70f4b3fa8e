"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration (`configs`, whose
`file` is a JSON deployment) and a traffic mix, the data file
traffic/<traffic>.json that load.py reads. A metric, end to end or per
layer, is read by metrics/<name>.py, whose `read(ctx)` returns a number or
None (nothing to read: the metric is left out of the line).
"""

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

__all__ = ["Spec", "Cell", "BENCH_DIR", "REPO_ROOT"]

BENCH_DIR = Path(__file__).resolve().parent.parent
REPO_ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config: dict            # the deployment file's contents
    traffic: dict           # the traffic file's contents
    chips: int
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list


class Spec:
    """BENCHMARK.json of a checkout (`root`: the directory holding it) and
    the benchmark's folder (`bench_dir`: configs/, traffic/, metrics/)."""

    def __init__(self, root=REPO_ROOT, bench_dir=BENCH_DIR):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir)
        with open(self.root / "BENCHMARK.json") as f:
            self.doc = json.load(f)
        self._readers = {}

    def config(self, name):
        """configs/<name>.json: a deployment, by its file's name."""
        with open(self.bench_dir / "configs" / f"{name}.json") as f:
            return json.load(f)

    def traffic(self, name):
        """traffic/<name>.json: a traffic mix."""
        with open(self.bench_dir / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def cell(self, name):
        """The Cell of workload `name`; KeyError names the known cells."""
        cells = {w["name"]: w for w in self.doc["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                           f"{sorted(cells)}")
        w = cells[name]
        configs = {c["name"]: c for c in self.doc["configs"]}
        with open(self.root / configs[w["config"]]["file"]) as f:
            config = json.load(f)
        traffic = self.traffic(w["traffic"])
        e2e = [m for m in self.doc["end_to_end"]
               if name in m.get("workloads", [name])]
        reported = {m["name"] for m in e2e}
        layer = [m for m in self.doc["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
        return Cell(name, config, traffic, int(w["chips"]), e2e, layer)

    def reader(self, metric):
        """metrics/<metric>.py's read function."""
        fn = self._readers.get(metric)
        if fn is None:
            path = self.bench_dir / "metrics" / f"{metric}.py"
            spec = importlib.util.spec_from_file_location(
                f"fsrbench_metric_{len(self._readers)}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            fn = self._readers[metric] = mod.read
        return fn
