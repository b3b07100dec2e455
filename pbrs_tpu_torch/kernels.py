"""Build and load the hand-written CUDA kernels under ``csrc/``.

The sources are compiled with nvcc into one shared library with a plain C
interface and loaded with ctypes (no PyTorch headers, so a build takes
seconds). The library lands in ``<repo>/build/pbrs_tpu_torch_kernels/``,
named by a content hash of the sources and flags, so an unchanged tree
reuses it and a changed one rebuilds. Nothing is built or loaded until a
kernel is first launched on a CUDA tensor.

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
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("trace_flat.cu", "fused_bounce.cu")
HEADERS = ("trace_flat.cuh",)
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "pbrs_tpu_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_VP = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: (name, argtypes). A launcher returns cudaGetLastError().
_SIGNATURES = {
    "pbrs_trace_flat": [_VP, _I, _I, _I, _I, _VP, _I, _VP, _VP, _I, _VP],
    "pbrs_fused_bounce": [_VP, _I, _I, _I, _I, _VP, _I, _VP, _I, _VP, _I,
                          _I, _I, _I, _I, _VP, _VP, _VP, _VP, _I, _VP, _VP,
                          _VP, _VP],
    "pbrs_error_string": [_I],
    "pbrs_max_bank_rows": [],
}

_lib = None


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


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


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
