"""Package rules of the PyTorch port: no JAX at run time, kernel sources
present and built with contraction off, no silent fallback."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import pbrs_tpu_torch
from pbrs_tpu_torch import kernels
from pbrs_tpu_torch.accel import fused_kernel as fk
from pbrs_tpu_torch.accel import fused_single_lobe as fsl
from pbrs_tpu_torch.accel import fused_wave as fw
from pbrs_tpu_torch.accel import trace_kernel as tk
from pbrs_tpu_torch.accel import treelet as tl
from pbrs_tpu_torch.geometry import ray as ray_mod
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

PKG = os.path.dirname(pbrs_tpu_torch.__file__)
REPO = os.path.dirname(PKG)
FORBIDDEN = ("jax", "jaxlib", "flax", "pbrs_tpu")


def _py_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_import_leaves_jax_out():
    code = (
        "import pkgutil, importlib, sys\n"
        "import pbrs_tpu_torch\n"
        "for m in pkgutil.walk_packages(pbrs_tpu_torch.__path__, "
        "'pbrs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pbrs_tpu')]\n"
        "assert not bad, bad\n"
        "import pbrs_tpu_torch.kernels as k\n"
        "assert k._lib is None  # nothing built at import\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


@pytest.mark.parametrize("path", sorted(_py_files()),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_module_imports_jax_or_reference(path):
    tree = ast.parse(open(path).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names


def test_kernel_sources_listed_and_flags():
    listed = {p.name for p in kernels.source_paths()}
    on_disk = {f for f in os.listdir(kernels.CSRC)
               if f.endswith((".cu", ".cuh"))}
    assert listed == on_disk and {
        "trace_flat.cu", "fused_bounce.cu", "fused_single_lobe.cu",
        "trace_bvh.cu", "fused_wave.cu", "shade_common.cuh"} <= listed
    flags = " ".join(kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags and "fast_math" not in flags
    replaced = {"trace_flat.cu": "trace_pallas.py:_trace_kernel",
                "fused_bounce.cu": "fused_kernel.py:_bounce_kernel",
                "fused_single_lobe.cu": "fused_single_lobe.py:_bounce2_kernel",
                "trace_bvh.cu": "treelet.py:_treelet_kernel",
                "fused_wave.cu": "fused_wave.py:_shade_kernel"}
    for name, pallas in replaced.items():
        assert pallas in (kernels.CSRC / name).read_text()
    # The library name follows the sources' content hash.
    assert kernels.library_path().parent == kernels.BUILD_DIR


def test_precision_policy():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_wrappers_take_no_other_device():
    """A tensor on neither the CPU nor CUDA raises: no quiet fallback."""
    from pbrs_tpu_torch.scene import presets

    tracer = tk.Tracer(presets.cornell_box().geom)
    rays = ray_mod.make_rays(torch.zeros(4, 3, device="meta"),
                             torch.ones(4, 3, device="meta"))
    with pytest.raises(ValueError):
        tracer.trace(rays)
    with pytest.raises(ValueError):
        tracer.occluded(rays)
    fin = torch.zeros(9, 4, device="meta")
    with pytest.raises(ValueError):
        fk.bounce(None, fin, None, None, None, None, seed=0, bounce=0,
                  bounce_is_first=True, rr_active=False)
    with pytest.raises(ValueError):
        fw.shade(None, fin, fin, None, seed=0, bounce=0, first=True,
                 rr_on=False)


def test_launch_counters_start_at_zero():
    assert tk.LAUNCHES == 0 and fk.LAUNCHES == 0 and fsl.LAUNCHES == 0
    assert tl.LAUNCHES == 0 and fw.LAUNCHES == 0


def test_new_modules_import_without_jax():
    """The slice's host copies and wave modules alone leave jax, flax and
    pbrs_tpu out of sys.modules (with the package's own imports)."""
    code = (
        "import sys\n"
        "import pbrs_tpu_torch.accel.fused_wave\n"
        "import pbrs_tpu_torch.accel.instanced\n"
        "import pbrs_tpu_torch.lights.env_sampling\n"
        "import pbrs_tpu_torch.radiometry, pbrs_tpu_torch.core.spline\n"
        "import pbrs_tpu_torch.scene.pbrt.loader\n"
        "import pbrs_tpu_torch.lane_diff\n"
        "import pbrs_tpu_torch.integrators.direct\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pbrs_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def test_every_source_is_compiled_on_its_own():
    """One nvcc per source (started together), with the ptxas report."""
    assert set(kernels.SOURCES) == {p.name for p in kernels.source_paths()
                                    if p.suffix == ".cu"}
    assert "-shared" not in kernels.NVCC_FLAGS
    assert kernels.ptxas_log_path().suffix == ".log"


def test_launch_signatures_match_the_sources():
    """Each C entry point's ctypes argument list (kernels._SIGNATURES)
    matches the prototype in its source, argument for argument: a pointer,
    an int or a float."""
    import ctypes
    import re

    seen = set()
    for src in kernels.SOURCES:
        text = (kernels.CSRC / src).read_text()
        for name, args in re.findall(r"\nint (pbrs_\w+)\(([^)]*)\)\s*\{",
                                     text):
            kinds = [ctypes.c_void_p if "*" in a else
                     ctypes.c_float if a.split()[0] == "float" else
                     ctypes.c_int
                     for a in (x.strip() for x in args.split(",")) if a]
            assert kinds == kernels._SIGNATURES[name], name
            seen.add(name)
    assert {"pbrs_fused_bounce", "pbrs_fused_single_lobe",
            "pbrs_fused_wave", "pbrs_trace_flat", "pbrs_trace_bvh"} <= seen
