"""BENCHMARK.json against the rules its format sets, and every name in it
found as a file by the harness; a dummy configuration, mix and metric
added as new files only are picked up."""
from __future__ import annotations

import json
import re

import pytest
from kkt_tiny import ROOT, bench, last_json, tiny_root

from kktbench import cells, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_rules():
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "kktbench/run.py"] and all(_line(w) for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) and not p.startswith("/") and ".." not in p
                                              for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cells_24 = 2 + 14 * 24
    assert cells_24 * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    used = {w["config"] for w in b["workloads"]}
    assert 1 <= len(b["configs"]) <= 24
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"])) and c["file"] not in files
        files.add(c["file"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) and k in data for k in c["reduced"])
        assert data["reduced"] == c["reduced"] and data["source"] == c["source"]
    pairs = set()
    assert 1 <= len(b["workloads"]) <= 24
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)
    names = [w["name"] for w in b["workloads"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert 1 <= len(b["per_layer"]) <= 128
    layers = {}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and _line(m["layer"]) and m["moves"] in e2e
        assert m["name"] not in e2e
        for w in m.get("workloads", names):
            assert w in names and w in e2e[m["moves"]].get("workloads", names)
        if m["unit"] == "%":
            assert m["name"].endswith("_roofline") or "share" in m["name"] or "mfu" in m["name"]
        layers.setdefault(m["layer"], []).append(m["name"])
    for w in names:
        reported = [m for m in b["end_to_end"] if w in m.get("workloads", names)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(w in m.get("workloads", names) for m in b["per_layer"])


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_every_name_is_a_file(workload):
    cell = cells.find(workload)
    entry = next(w for w in bench()["workloads"] if w["name"] == workload)
    assert cell.chips == entry["chips"] and cell.config["name"] == entry["config"] and cell.traffic["name"] == entry["traffic"]
    assert all(callable(m.reader.read) for m in cell.metrics)
    assert {m.name for m in cell.reported(0)} >= {"setup_s", "peak_mem_gib"}
    assert cell.reported(1)
    for key in ("problem", "grid_nodes", "dtype", "options", "limits", "controls", "source", "reduced", "assumed"):
        assert key in cell.config
    assert set(cell.config["limits"]) <= {*cell.problem.NUMBERS, "unconverged"}


def test_new_files_are_picked_up(tmp_path, capsys):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and new entries: the harness runs the new cell and reads the new
    metric, with no file of the harness changed."""
    root = tiny_root(tmp_path)
    conf = json.loads((root / "kktbench/configs/kkt2241_mg.json").read_text())
    conf.update(name="dummy", grid_nodes=13, reduced=[])
    (root / "kktbench/configs/dummy.json").write_text(json.dumps(conf))
    traffic = json.loads((root / "kktbench/traffic/rhs.json").read_text())
    traffic.update(name="dummy_mix", modes=3)
    (root / "kktbench/traffic/dummy_mix.json").write_text(json.dumps(traffic))
    (root / "kktbench/metrics/dummy.units.py").write_text("def read(rec):\n    return rec['units']\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "dummy", "source": "https://example.org/dummy", "file": "kktbench/configs/dummy.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "dummy.dummy_mix", "config": "dummy", "traffic": "dummy_mix", "chips": 1,
                           "why": "a test"})
    b["end_to_end"][0]["workloads"].append("dummy.dummy_mix")
    b["per_layer"].append({"name": "dummy.units", "unit": "units", "better": "higher", "source": "program_counter",
                           "layer": "Krylov loop", "moves": "solve_s", "workloads": ["dummy.dummy_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = cells.find("dummy.dummy_mix", root)
    assert cell.config["grid_nodes"] == 13 and cell.traffic["modes"] == 3
    assert "dummy.units" in {m.name for m in cell.reported(1)}
    argv = ["--workload", "dummy.dummy_mix", "--seed", "3", "--seconds", "0.5", "--trace", "1", "--root", str(root)]
    assert run.main(argv, platform="cpu") == 0
    line = last_json(capsys.readouterr().out)
    assert line["correct"] and line["metrics"]["dummy.units"]["value"] == line["attempted"]
