"""The port's profiler hooks and the CLI flags that reach them, against
pbrs_tpu on the CPU: ``profile_phases`` returns pbrs_tpu.profiling's keys
on the same small scene, ``profiler_trace`` writes a Chrome trace
(``render_image(profile_dir=)``, --profile_dir), every option string of
pbrs_tpu's CLI parses in the port's, --phase_timings prints the phases,
and the TPU trace modes are refused."""

import glob
import json

import jax
import pytest

from pbrs_tpu import cli as jcli
from pbrs_tpu import profiling as jprof
from pbrs_tpu.scene import presets as jpresets
from pbrs_tpu_torch import cli, profiling, render
from pbrs_tpu_torch.scene import buffers
from test_fused_single_lobe import _shrunk
import torch_threads  # noqa: F401  (one PyTorch thread a worker)


@pytest.fixture(scope="module")
def cornell():
    """(pbrs_tpu's Cornell box at 8^2, the port's carried copy)."""
    jscene = _shrunk(jpresets.cornell_box(), 8)
    return jscene, buffers.scene_from_arrays(buffers.scene_to_arrays(jscene))


def test_profile_phases_keys_match_reference(cornell):
    jscene, tscene = cornell
    with jax.disable_jit():
        want = jprof.profile_phases(jscene, n_pixels=64, max_depth=1,
                                    use_pallas=False, iters=1)
    got = profiling.profile_phases(tscene, n_pixels=64, max_depth=1,
                                   device="cpu", iters=1)
    assert list(got) == list(want)
    assert got["lanes"] == 64
    assert all(got[k] > 0 for k in ("raygen_ms", "trace_ms", "occlude_ms",
                                    "bounce1_ms", "full_ms"))


def _trace_names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_profiler_trace_writes_chrome_trace(cornell, tmp_path):
    """A no-op without a directory; with one, render_image's sample loop
    lands in a Chrome trace there, its passes named by the recorder, which
    is off again after the window."""
    tscene = cornell[1]
    with profiling.profiler_trace(None):
        pass
    with profiling.profiler_trace(""):
        pass
    assert not list(tmp_path.iterdir())
    img, _ = render.render_image(tscene, spp=1, max_depth=2, device="cpu",
                                 profile_dir=str(tmp_path / "prof"))
    files = glob.glob(str(tmp_path / "prof" / "*.json"))
    assert len(files) == 1 and img.shape == (8, 8, 3)
    names = _trace_names(files[0])
    assert any(n and n.startswith("aten::") for n in names)
    assert "pbrs.pass" in names
    assert profiling.span("pbrs.pass") is profiling.span("pbrs.bounce")


def _sample_argv(action):
    opt = action.option_strings[0]
    if action.nargs == 0:
        return [[opt]]
    if action.choices:
        return [[opt, str(c)] for c in action.choices]
    if action.type is int:
        return [[opt, "3"]]
    return [[opt, "x"]]


def test_every_reference_flag_parses():
    """Each option string of pbrs_tpu's CLI, with each of its choices,
    parses in the port's parser with nothing left over."""
    ours = cli.build_parser()
    theirs = jcli.build_parser()
    seen = 0
    for action in theirs._actions:
        if not action.option_strings or action.dest == "help":
            continue
        for argv in _sample_argv(action):
            _, rest = ours.parse_known_args(argv)
            assert rest == [], argv
            seen += 1
    assert seen > 20


@pytest.mark.parametrize("mode", ["rowdense", "rowdyn", "rowdynh"])
def test_tpu_trace_modes_refused(mode):
    with pytest.raises(SystemExit, match="TPU treelet fetch variant"):
        cli.main(["--trace_mode", mode, "--device", "cpu"])


def test_cli_phase_timings_and_profile_dir(tmp_path, capsys):
    """--phase_timings prints the phases before the render, --profile_dir
    writes its trace, --trace_mode onehot takes the one tracer pair."""
    out = str(tmp_path / "c.png")
    prof = tmp_path / "prof"
    assert cli.main(["--scene_name", "cornell_box", "--resolution", "8x8",
                     "--msaa", "1", "--depth", "2", "--device", "cpu",
                     "--trace_mode", "onehot", "--phase_timings",
                     "--profile_dir", str(prof), "--output", out]) == 0
    said = capsys.readouterr().out
    assert "per-phase device timings (1 launch):" in said
    for key in ("raygen_ms", "trace_ms", "occlude_ms", "shade_nee_ms",
                "trace_mrays_s"):
        assert f"  {key}: " in said
    assert "plain path on cpu" in said
    assert len(list(prof.glob("*.json"))) == 1
