"""A run with the timed path broken underneath comes out not correct, for
each fault the cells can have; the same run unbroken comes out correct.
The harness's look for a card is skipped (device "cpu", tiny cells)."""

from __future__ import annotations

import json
import time

import pytest

from portbench import harness
from portbench.tests import faults, tiny


@pytest.fixture
def root(tmp_path):
    return tiny.make_root(tmp_path)


def _final(root):
    return harness.load_cell(tiny.add_cell(
        root, "tiny_cornell", tiny.tiny_config(frame_spp=4096), "final"),
        root)


def _sharded(root, plant=None):
    mix = json.loads((root / "portbench/traffic/frames16.json").read_text())
    mix["plant"] = plant
    name = "frames_" + (plant.split(":")[1] if plant else "sound")
    cfg = tiny.tiny_config("interior_1080p_sp4", frame_spp=4,
                           layout={"dp": 1, "sp": 2}, chips=2,
                           scene=tiny.tiny_config()["scene"])
    return harness.load_cell(tiny.add_cell(root, "tiny_sp2", cfg, name,
                                           chips=2, traffic_file=mix), root)


def _correct(cell, seed=2**31 + 3):
    return harness.run_cell(cell, seed, 0.5, False, "cpu",
                            time.time())["correct"]


def test_final_frame_sound(root):
    assert _correct(_final(root))


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_final_frame_fault(root, monkeypatch, kind):
    cell = _final(root)
    faults.patch_render(monkeypatch, kind)
    assert not _correct(cell)


def test_sharded_sound(root):
    assert _correct(_sharded(root))


@pytest.mark.parametrize("plant", ["no_exchange", "unchanged", "half",
                                   "altered"])
def test_sharded_fault(root, plant):
    assert not _correct(_sharded(root, f"portbench.tests.faults:{plant}"))
