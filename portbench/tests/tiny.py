"""Tiny cells for the CPU tests: a root laid out as a checkout, holding
BENCHMARK.json and copies of the benchmark's data files, with cells of
its own added by new data files only."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DATA_DIRS = ("metrics", "kernels", "traffic", "configs")


def make_root(tmp: Path) -> Path:
    root = Path(tmp)
    (root / "portbench").mkdir(parents=True, exist_ok=True)
    for d in DATA_DIRS:
        shutil.copytree(REPO / "portbench" / d, root / "portbench" / d,
                        dirs_exist_ok=True)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def tiny_config(base: str = "cornell_1024_d8", **over) -> dict:
    """A configuration file of the benchmark cut to a CPU test's size."""
    with open(REPO / "portbench" / "configs" / f"{base}.json") as f:
        cfg = json.load(f)
    cfg.update(width=16, height=16, max_depth=3)
    cfg["check"] = dict(cfg["check"], pixels=256)
    cfg.update(over)
    return cfg


def add_cell(root: Path, name: str, config: dict, traffic: str,
             chips: int = 1, traffic_file: dict | None = None,
             metrics=()) -> str:
    """Add configuration `name` and cell `name.traffic` by new files and
    entries only; `traffic_file` writes a new mix; `metrics` are
    (entry, reader source) pairs of new per-layer metrics."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "portbench" / "configs" / f"{name}.json").write_text(
        json.dumps(config))
    if traffic_file is not None:
        (root / "portbench" / "traffic" / f"{traffic}.json").write_text(
            json.dumps(traffic_file))
    cell = f"{name}.{traffic}"
    bench["configs"].append({"name": name, "source": "a CPU test",
                             "file": f"portbench/configs/{name}.json",
                             "reduced": [], "why": "a CPU test"})
    bench["workloads"].append({"name": cell, "config": name,
                               "traffic": traffic, "chips": chips,
                               "why": "a CPU test"})
    for entry, source in metrics:
        bench["per_layer"].append(entry)
        (root / "portbench" / "metrics" / f"{entry['name']}.py").write_text(
            source)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell
