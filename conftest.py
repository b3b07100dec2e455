"""Test scheduling for ``pytest -n N --dist loadfile``: longest file first.

xdist's ``loadfile`` hands whole files to workers in order of test count,
largest first, so a file of two slow tests starts among the last and sets
the run's wall time. This hook keeps the files whole and changes only the
order: files go out longest first (``FILE_SECONDS``, seconds a file took
under ``tests/``'s six-worker run, read from its JUnit XML), and a worker
takes its next file only when it holds the last test of its current one,
so no file waits behind two tests of another. Which tests run, and what
they assert, does not change.

A file missing from the table counts ``UNKNOWN_SECONDS_A_TEST`` a test.
Re-record the table from a run's XML with
``python conftest.py /path/to/junit.xml`` (prints the new table).
"""

from __future__ import annotations

import sys

import pytest

UNKNOWN_SECONDS_A_TEST = 5.0

# Seconds a file took (setup, call and teardown of its tests summed) in
# one run of ``pytest tests/ -n 6 --dist loadfile`` on 8 CPU cores.
FILE_SECONDS = {
    "test_sharded_paths.py": 777.6,
    "test_fused_single_lobe.py": 643.3,
    "test_compaction.py": 479.8,
    "test_fused_wave.py": 456.8,
    "test_presets.py": 401.9,
    "test_rowdense.py": 343.2,
    "test_folded_nee.py": 280.6,
    "test_golden.py": 273.8,
    "test_env_sampling.py": 272.2,
    "test_integrator.py": 232.1,
    "test_fused.py": 175.8,
    "test_torch_pbrt.py": 135.5,
    "test_tuner.py": 132.0,
    "test_persistent.py": 131.6,
    "test_torch_bvh_trace.py": 130.2,
    "test_torch_fourier.py": 122.2,
    "test_render.py": 116.9,
    "test_torch_compaction.py": 116.2,
    "test_torch_tuner.py": 101.2,
    "test_instanced.py": 114.0,
    "test_fourier.py": 104.1,
    "test_torch_wave.py": 101.9,
    "test_torch_lights.py": 87.5,
    "test_torch_plates_lanes.py": 81.3,
    "test_bvh.py": 78.2,
    "test_torch_folded.py": 77.7,
    "test_torch_single_lobe_scenes.py": 77.5,
    "test_debug_audit.py": 75.8,
    "test_torch_fused_sky.py": 73.0,
    "test_torch_render_options.py": 72.4,
    "test_torch_profiling.py": 40.0,
    "test_torch_single_lobe.py": 66.1,
    "test_torch_trace.py": 64.7,
    "test_torch_fused.py": 56.4,
    "test_bxdf.py": 49.2,
    "test_torch_parallel.py": 50.0,
    "test_torch_instanced.py": 48.8,
    "test_torch_mesh.py": 44.5,
    "test_torch_sobol_kernels.py": 44.3,
    "test_torch_env.py": 41.2,
    "test_torch_persistent.py": 37.3,
    "test_partition.py": 34.3,
    "test_torch_sobol.py": 32.1,
    "test_torch_trace_layout.py": 28.8,
    "test_torch_mesh_bvh.py": 23.1,
    "test_torch_direct.py": 21.5,
    "test_pbrt.py": 19.8,
    "test_torch_render.py": 18.4,
    "test_spline_filters.py": 18.0,
    "test_treelet.py": 17.2,
    "test_lights.py": 15.3,
    "test_sampler.py": 12.2,
    "test_torch_bxdf.py": 11.2,
    "test_shapes.py": 10.5,
    "test_torch_package.py": 9.2,
    "test_torch_image.py": 5.4,
    "test_torch_sampler.py": 4.4,
    "test_vecmath.py": 4.1,
    "test_torch_filters.py": 2.2,
    "test_trace_pallas.py": 1.9,
    "test_torch_bounce_layout.py": 0.7,
    "test_torch_prof_rounds.py": 0.5,
    "test_torch_scene.py": 0.3,
    "test_radiometry.py": 0.0,
}


def file_seconds(scope: str, n_tests: int) -> float:
    name = scope.replace("\\", "/").rsplit("/", 1)[-1]
    if name in FILE_SECONDS:
        return FILE_SECONDS[name]
    return UNKNOWN_SECONDS_A_TEST * n_tests


try:
    from xdist.scheduler import LoadFileScheduling
except ImportError:  # xdist absent: nothing to schedule
    LoadFileScheduling = None

if LoadFileScheduling is not None:

    class LongestFileFirst(LoadFileScheduling):
        """``loadfile`` with the queue in order of recorded seconds and a
        file handed out when a worker's last test is all it holds."""

        _sorted = False

        def _assign_work_unit(self, node) -> None:
            if not self._sorted:
                units = sorted(self.workqueue.items(),
                               key=lambda u: -file_seconds(u[0], len(u[1])))
                self.workqueue.clear()
                self.workqueue.update(units)
                self._sorted = True
            super()._assign_work_unit(node)

        def _reschedule(self, node) -> None:
            if node.shutting_down:
                return
            if not self.workqueue:
                node.shutdown()
                return
            # A worker runs a test once it knows the next one, so a worker
            # holding one pending test is idle and waits for this file.
            if self._pending_of(self.assigned_work[node]) > 1:
                return
            self._assign_work_unit(node)

    @pytest.hookimpl(tryfirst=True)
    def pytest_xdist_make_scheduler(config, log):
        if config.getvalue("dist") != "loadfile":
            return None
        return LongestFileFirst(config, log)


def _table_from_junit(path: str) -> dict:
    import xml.etree.ElementTree as ET

    seconds = {}
    for case in ET.parse(path).getroot().iter("testcase"):
        module = case.get("classname", "").split(".")
        # classname is tests.test_x or tests.test_x.Class
        name = next((m for m in module if m.startswith("test_")), None)
        if name is None:
            continue
        key = name + ".py"
        seconds[key] = seconds.get(key, 0.0) + float(case.get("time", 0.0))
    return dict(sorted(seconds.items(), key=lambda kv: -kv[1]))


if __name__ == "__main__":
    for key, value in _table_from_junit(sys.argv[1]).items():
        print(f'    "{key}": {value:.1f},')
