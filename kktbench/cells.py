"""Everything a cell needs, found by name from BENCHMARK.json: its
configuration (kktbench/configs/<config>.json, the entry's `file`), the
problem that configuration names (kktbench/problems/<problem>.py), its
traffic mix (kktbench/traffic/<traffic>.json) and a reader for each metric
it reports (kktbench/metrics/<metric>.py). Adding a configuration, a
problem, a mix or a metric is adding its file and its entry; no file here
changes."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    source: str
    end_to_end: bool
    reader: object  # the module: read(rec) -> number or None, optional probe(ctx)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    problem: object  # the module: assemble, rhs, answer, Check, NUMBERS
    traffic: dict
    metrics: tuple  # of Metric: end-to-end first, then per-layer

    def reported(self, trace):
        """The metrics a run reports: per-layer with --trace 1, else
        end-to-end."""
        return tuple(m for m in self.metrics if m.end_to_end != bool(trace))


def load_module(kind, name, root=ROOT):
    """The module kktbench/<kind>/<name>.py (a metric's reader, a problem)."""
    path = Path(root) / "kktbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"kktbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find(workload, root=ROOT):
    """The Cell named `workload` in root/BENCHMARK.json, its files under
    root; KeyError when there is none."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in {root / 'BENCHMARK.json'}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "kktbench" / "traffic" / f"{entry['traffic']}.json").read_text())
    metrics = []
    for group, e2e in (("end_to_end", True), ("per_layer", False)):
        for m in bench[group]:
            if workload in m.get("workloads", [workload]):
                metrics.append(Metric(m["name"], m["unit"], m["source"], e2e, load_module("metrics", m["name"], root)))
    problem = load_module("problems", config["problem"], root)
    return Cell(workload, int(entry["chips"]), config, problem, traffic, tuple(metrics))
