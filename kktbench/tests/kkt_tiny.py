"""Tiny copies of the benchmark for the CPU tests: the real traffic mixes,
metric readers, problems and BENCHMARK.json, with each configuration cut
to a grid of a few hundred nodes, and a four-card cell added as a later
change would add it (entries only), so that the harness's path across
ranks runs too: four gloo ranks on the CPU."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

GRIDS = {"kkt2241_mg": 17}
FOUR_CARD = {"name": "kkt2241_mg.rhs4", "config": "kkt2241_mg", "traffic": "rhs", "chips": 4,
             "why": "config 5 on a 2 x 2 world"}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def with_four_card(b):
    """BENCHMARK.json's dict with the four-card cell added to its entries."""
    b["workloads"].append(FOUR_CARD)
    for m in b["end_to_end"] + b["per_layer"]:
        # matvec_roofline reads a world of one only
        if m.get("moves", m["name"]) == "solve_s" and "workloads" in m and m["name"] != "matvec_roofline":
            m["workloads"].append(FOUR_CARD["name"])
    return b


def tiny_root(tmp, grids=GRIDS):
    """A root under tmp holding BENCHMARK.json (with the four-card cell) and
    kktbench's traffic, metrics, problems and configs, each configuration's
    grid set from `grids`."""
    tmp = Path(tmp)
    for sub in ("traffic", "metrics", "problems", "configs"):
        shutil.copytree(ROOT / "kktbench" / sub, tmp / "kktbench" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (tmp / "BENCHMARK.json").write_text(json.dumps(with_four_card(bench())))
    for name, n in grids.items():
        path = tmp / "kktbench" / "configs" / f"{name}.json"
        data = json.loads(path.read_text())
        data["grid_nodes"] = n
        path.write_text(json.dumps(data))
    return tmp


def last_json(text):
    """The JSON object on the last line of `text`."""
    return json.loads(text.strip().splitlines()[-1])
