"""The harness on the CPU at a tiny size: cells found by name from data
files alone, the result line's keys, no fallback without a card, and no
JAX in any process the benchmark starts."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests import tiny

REPO = tiny.REPO
NEW_METRIC = '''"""passes_seen: the passes the window finished (a test metric)."""


def read(rec, cell):
    return float(rec.passes)
'''


@pytest.fixture
def root(tmp_path):
    return tiny.make_root(tmp_path)


def _new_cell(root):
    """A configuration, a mix and a per-layer metric, each a new file,
    and new entries in BENCHMARK.json."""
    mix = json.loads((root / "portbench/traffic/final.json").read_text())
    mix["profile_after_seconds"] = 0.1
    mix["profile_min_passes"] = 1
    mix["profile_seconds"] = 0.2
    return tiny.add_cell(
        root, "tiny_cornell", tiny.tiny_config(frame_spp=4096), "final_quick",
        traffic_file=mix,
        metrics=[({"name": "passes_seen", "unit": "1", "better": "higher",
                   "source": "host_clock", "layer": "render loop",
                   "moves": "samples_per_s",
                   "workloads": ["tiny_cornell.final_quick"]}, NEW_METRIC)])


def test_new_cell_from_data_files_runs(root):
    name = _new_cell(root)
    cell = harness.load_cell(name, root)
    assert cell.traffic["loop"] == "final_frame"
    out = harness.run_cell(cell, 2**31 + 11, 1.0, False, "cpu", time.time())
    assert out["correct"] and out["attempted"] >= 1
    assert set(out["metrics"]) == {"samples_per_s", "setup_s"}
    traced = harness.run_cell(cell, 2**31 + 12, 1.5, True, "cpu",
                              time.time())
    assert traced["correct"]
    assert traced["metrics"]["passes_seen"]["value"] >= 1
    assert "scene_load_s" in traced["metrics"]


def test_a_listed_metric_that_reads_nothing_fails(root):
    mix = json.loads((root / "portbench/traffic/final.json").read_text())
    mix["profile_after_seconds"] = 0.1
    name = tiny.add_cell(
        root, "tiny_silent", tiny.tiny_config(frame_spp=4096), "final_silent",
        traffic_file=mix,
        metrics=[({"name": "silent", "unit": "1", "better": "higher",
                   "source": "device_trace", "layer": "render loop",
                   "moves": "samples_per_s",
                   "workloads": ["tiny_silent.final_silent"]},
                  "def read(rec, cell):\n    return None\n")])
    cell = harness.load_cell(name, root)
    with pytest.raises(harness.MissingMetric, match="silent"):
        harness.run_cell(cell, 2**31 + 13, 0.5, True, "cpu", time.time())


def test_result_keys(root):
    cell = harness.load_cell(_new_cell(root), root)
    out = harness.run_cell(cell, 5, 0.5, False, "cpu", time.time())
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["device"]["platform"] == "cpu"
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(out["checks"]["film_rel_l1"]) == {"value", "limit"}
    json.dumps(out)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "cornell_1024_d8.final", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no result" in proc.stderr


def test_only_bench_files_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/ fails."""
    import shutil

    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "cornell_1024_d8.final", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_run_loads_no_jax(root):
    name = _new_cell(root)
    code = (
        "import json, sys, time\n"
        "from portbench import harness\n"
        f"cell = harness.load_cell({name!r}, {str(root)!r})\n"
        "harness.run_cell(cell, 9, 0.5, False, 'cpu', time.time())\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300,
                          check=True)
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def _imports(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return [n.split(".")[0] for n in names]


def _sources(sub):
    return sorted((REPO / "portbench" / sub).rglob("*.py"))


@pytest.mark.parametrize("path", _sources("reference"),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_reference_imports_nothing_of_the_program(path):
    bad = {"jax", "jaxlib", "flax", "pbrs_tpu", "pbrs_tpu_torch"}
    assert not bad & set(_imports(path))


@pytest.mark.parametrize(
    "path", [p for p in sorted((REPO / "portbench").rglob("*.py"))
             if "tests" not in p.parts],
    ids=lambda p: str(p.relative_to(REPO)))
def test_harness_imports_no_jax(path):
    assert not {"jax", "jaxlib", "flax", "pbrs_tpu"} & set(_imports(path))


def test_names_compared_whole():
    mods = dict(sys.modules)
    try:
        sys.modules["pbrs_tpu_torch_fake"] = sys
        assert "pbrs_tpu_torch_fake" not in harness.forbidden_modules()
        sys.modules["pbrs_tpu.fake"] = sys
        assert "pbrs_tpu.fake" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(mods)


def test_sharded_trace_profiles_one_batch(root):
    from portbench.loops import sharded_frames

    cfg = tiny.tiny_config("interior_1080p_sp4", frame_spp=4,
                           layout={"dp": 1, "sp": 2}, chips=2,
                           scene=tiny.tiny_config()["scene"])
    # Profile frame 0, which every window holds however slow the host.
    mix = json.loads((root / "portbench/traffic/frames16.json").read_text())
    mix["profile_after_frames"] = 0
    cell = harness.load_cell(tiny.add_cell(root, "tiny_sp2", cfg,
                                           "frames_now", chips=2,
                                           traffic_file=mix), root)
    ctx = harness.Ctx(cell=cell, seed=21, seconds=0.5, trace=True,
                      device="cpu", t0=time.time())
    rec = sharded_frames.run(ctx)
    # Frame 0's first batch: 2 sample indices over sp 2, a pass a rank.
    assert rec.profiled_passes == 2 and rec.ranks == 2
    assert rec.trace is not None and rec.trace.window_s > 0.0
    assert rec.attempted >= 1 and rec.checks["film_rel_l1"][0] < 1e-6


def test_traced_stretch_leaves_passes_for_host_cpu(root, capsys):
    """However soon the first pass ends, the profiler opens only once
    `profile_after_passes` passes are done, so the steady passes before
    it still time the host's CPU."""
    import re

    from portbench.loops import final_frame

    mix = json.loads((root / "portbench/traffic/final.json").read_text())
    mix["profile_after_seconds"] = 0.0
    mix["profile_min_passes"] = 1
    mix["profile_seconds"] = 0.0
    name = tiny.add_cell(root, "tiny_early", tiny.tiny_config(frame_spp=4096),
                         "final_early", traffic_file=mix)
    cell = harness.load_cell(name, root)
    ctx = harness.Ctx(cell=cell, seed=2**31 + 21, seconds=2.0, trace=True,
                      device="cpu", t0=time.time())
    rec = final_frame.run(ctx)
    first = int(re.search(r"traced passes (\d+)-",
                          capsys.readouterr().err).group(1))
    assert first == mix["profile_after_passes"]
    assert rec.trace is not None and rec.profiled_passes >= 1
    assert rec.host_passes >= first - 1 >= 1
