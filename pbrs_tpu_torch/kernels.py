"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each source is compiled by its own nvcc process, all started together, and
the objects are linked into one shared library with a plain C interface,
loaded with ctypes (no PyTorch headers, so a build takes seconds). The
library lands in ``<repo>/build/pbrs_tpu_torch_kernels/``, named by a
content hash of the sources and flags, so an unchanged tree reuses it and a
changed one rebuilds; ``-Xptxas -v`` (registers, spills, shared memory per
kernel) goes to a ``.ptxas.log`` beside it. Nothing is built or loaded
until a kernel is first launched on a CUDA tensor.

Numerics: no ``--use_fast_math`` and ``-fmad=false``. PyTorch's plain
versions run one op per kernel and never contract ``a*b+c`` into an FMA;
with contraction off, a kernel and its plain version round identically.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("trace_flat.cu", "fused_bounce.cu", "fused_single_lobe.cu",
           "trace_bvh.cu", "fused_wave.cu", "trace_prim_bvh.cu",
           "mm_probe.cu")
HEADERS = ("trace_flat.cuh", "ray_queue.cuh", "bounce_common.cuh",
           "shade_common.cuh")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "pbrs_tpu_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: (name, argtypes). A launcher returns cudaGetLastError().
_SIGNATURES = {
    "pbrs_trace_flat": [_VP, _VP, _VP, _I, _I, _VP, _VP, _I, _VP],
    "pbrs_fused_bounce": [_VP, _I, _I, _I, _I, _VP, _I, _VP, _I, _VP, _I,
                          _I, _I, _I, _I, _I, _VP, _VP, _VP, _VP, _I, _VP,
                          _VP, _VP, _VP],
    "pbrs_fused_bounce_info": [_I, _VP],
    "pbrs_fused_single_lobe": [_VP, _I, _I, _I, _I, _VP, _I, _I, _VP, _I,
                               _VP, _I, _I, _VP, _I, _VP, _I, _VP, _I, _I, _I,
                               _I, _I, _I, _I, _VP, _VP, _VP, _VP, _VP, _I,
                               _VP, _VP, _VP, _VP, _VP],
    "pbrs_fused_single_lobe_info": [_I, _VP],
    "pbrs_trace_bvh": [_VP, _VP, _VP, _I, _VP, _VP, _VP, _I, _I, _I, _VP,
                       _VP, _I, _VP],
    "pbrs_fused_wave": [_VP, _I, _I, _I, _VP, _I, _VP, _I, _VP, _I, _F, _I,
                        _I, _I, _I, _I, _I, _I, _I, _I, _VP, _I, _VP, _I,
                        _VP, _VP, _VP, _VP],
    "pbrs_fused_wave_info": [_I, _I, _I, _VP],
    "pbrs_trace_prim_bvh": [_VP, _I, _I, _VP, _VP, _I, _VP, _I, _VP, _VP,
                            _I, _VP],
    "pbrs_trace_prim_bvh_info": [_I, _I, _I, _VP],
    "pbrs_mm_probe": [_VP, _VP, _I, _I, _I, _VP, _VP],
    "pbrs_error_string": [_I],
    "pbrs_max_bank_rows": [],
    "pbrs_flat_max_bytes": [],
    "pbrs_bvh_max_stack_depth": [],
    "pbrs_prim_bvh_max_stack_depth": [],
}

_lib = None
# Lanes a warp of the trace kernels K1 and K5 takes (csrc/ray_queue.cuh),
# for a closest-hit and an any-hit launch: a closest-hit warp keeps 32
# neighbouring lanes, whose rays cull alike; an any-hit launch (twice the
# lanes, sparsely live) packs the live rays of 128 into full warps.
TRACE_CLAIM = (32, 128)


def source_paths():
    return [CSRC / f for f in SOURCES + HEADERS]


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return str(path)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in source_paths():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libpbrs_tpu_torch_{h.hexdigest()[:16]}.so"


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> Path:
    """Compile the kernels unless a library for these sources exists: one
    nvcc per source, started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(src).stem}.o" for src in SOURCES]
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        logs = list(pool.map(_run, [
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
             str(CSRC / src)] for src, obj in zip(SOURCES, objs)]))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
          *(str(o) for o in objs)])
    for obj in objs:
        obj.unlink()
    ptxas_log_path().write_text("".join(
        f"== {src}\n{log}" for src, log in zip(SOURCES, logs)))
    os.replace(tmp, out)
    return out


def ptxas_log_path() -> Path:
    return library_path().with_suffix(".ptxas.log")


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_char_p if name == "pbrs_error_string" \
                else ctypes.c_int
        _lib = handle
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib().pbrs_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
