"""The control at a test's size: the reference with its rays held in
bfloat16, put in the program's place, fails the limit each configuration
states, while the program passes it."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import check, control, scenes
from portbench.loops import final_frame as ff
from portbench.tests import tiny


@pytest.mark.parametrize("base", ["cornell_1024_d8", "interior_1080p_sp4"])
def test_control_fails_the_limit(base):
    cfg = tiny.tiny_config()  # a preset scene small enough for the CPU
    cfg["check"] = dict(cfg["check"],
                        limit=tiny.tiny_config(base)["check"]["limit"])
    scene = scenes.reference_scene(cfg, tiny.REPO)
    pixels = check.check_pixels(3, 256, 256)
    got = control.control_reading(cfg, scene, 3, pixels, 4, 2, "cpu")
    assert got > check.limit(cfg)


def test_program_reading_passes_where_control_fails(tmp_path):
    from portbench import harness

    root = tiny.make_root(tmp_path)
    cell = harness.load_cell(tiny.add_cell(
        root, "tiny_cornell", tiny.tiny_config(frame_spp=4096), "final"),
        root)
    rows = control.final_frame_readings(cell, [41, 42], {42}, 0.5, "cpu")
    assert all(r["program"] <= check.limit(cell.config) for r in rows)
    assert rows[1]["control"] > check.limit(cell.config)
    assert np.isfinite(rows[1]["control"])
    assert ff.msaa_of(4096) == 64
