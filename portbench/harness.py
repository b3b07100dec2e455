"""Finding a cell by name, running it, and the result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix. Its files are found by name under the
root given: the configuration's ``file``, ``portbench/traffic/<mix>.json``,
and a reader ``portbench/metrics/<metric>.py`` for every metric the cell
reports. The mix names its loop, ``portbench/loops/<loop>.py``, whose
``run(ctx)`` sets up, measures, checks and returns what the readers read
(``RunRecord``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pbrs_tpu")


class MissingMetric(RuntimeError):
    """A metric the cell must report read nothing: on the card every
    metric that applies to the cell, and anywhere one that names the cell
    in its ``workloads``. The run prints no result."""


@dataclass
class Cell:
    root: Path
    name: str
    chips: int
    config: dict
    traffic: dict
    # The metric entries of BENCHMARK.json this cell reports, by kind.
    end_to_end: list
    per_layer: list


@dataclass
class Ctx:
    """What a loop is given: the cell, the run's arguments, the device
    ("cuda", or "cpu" in the tests) and the process's start time."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float


@dataclass
class RunRecord:
    """What a loop measured; the metric readers read it."""
    attempted: int = 0
    failed: int = 0
    # Pixel samples of every pass finished in the window, and the window.
    samples: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    scene_load_s: float = 0.0
    passes: int = 0
    # The process's CPU seconds over the passes they were counted on.
    host_cpu_s: float = 0.0
    host_passes: int = 0
    memory_peak_bytes: int = 0
    # The traced stretch (trace.TraceSummary, ranks merged), the passes a
    # rank rendered in it (summed over ranks) and the frame's lanes.
    trace: object = None
    profiled_passes: int = 0
    frame_lanes: int = 0
    # The share of the frame's lanes alive as each bounce begins (the
    # reference's count at the check pixels) and the traced rays a pass.
    live_per_bounce: list = field(default_factory=list)
    rays_per_pass: int = 0
    ranks: int = 1
    # {name: (value, limit)} of the comparison with the reference.
    checks: dict = field(default_factory=dict)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell of BENCHMARK.json named `workload`, with its files read."""
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "portbench" / "traffic" / f"{w['traffic']}.json")
    return Cell(root=root, name=workload, chips=int(w["chips"]),
                config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, workload)])


def cache_env(root: Path) -> None:
    """Every build and kernel cache a run may write, in fixed directories
    inside the checkout (the port's own nvcc and host builds already land
    in ``build/`` there)."""
    base = Path(root) / "build" / "portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv"),
                     ("PBRS_TUNER_CACHE", "tuner")):
        os.environ[var] = str(base / sub)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``pbrs_tpu_torch`` is not ``pbrs_tpu``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _load_reader(root: Path, name: str):
    path = Path(root) / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t0: float) -> dict:
    """Run the cell's loop and build the result object (the contract's
    last line). The card's presence is the caller's check."""
    loop = importlib.import_module(f"portbench.loops.{cell.traffic['loop']}")
    ctx = Ctx(cell=cell, seed=int(seed), seconds=float(seconds),
              trace=bool(trace), device=device, t0=t0)
    rec = loop.run(ctx)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = _load_reader(cell.root, m["name"]).read(rec, cell)
        if value is None:
            if cell.name in m.get("workloads", ()) or device == "cuda":
                raise MissingMetric(f"{m['name']} found nothing to read in "
                                    f"{cell.name}, which must report it")
            print(f"portbench: {m['name']} found nothing to read in "
                  f"{cell.name}; left out", file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(math.isfinite(v) and v <= lim
                  for v, lim in rec.checks.values()) and bool(rec.checks)
    out = {"correct": correct, "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics,
           "device": device_info(device, cell.chips, rec)}
    if trace and rec.trace is not None:
        out["breakdown"] = rec.trace.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in rec.checks.items()}
    return out


def device_info(device: str, chips: int, rec: RunRecord) -> dict:
    import torch

    on_card = device == "cuda"
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": chips, "memory_peak_bytes": int(rec.memory_peak_bytes)}
    if rec.trace is not None:
        info["busy_s"] = rec.trace.busy_s
        info["window_s"] = rec.trace.window_s
    return info
