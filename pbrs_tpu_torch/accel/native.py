"""ctypes bindings for the native host library. Mirrors
pbrs_tpu/accel/native.py over the port's own copy of the source,
pbrs_tpu_torch/native/pbrs_host.cpp.

Compiled on first use with g++ into build/pbrs_tpu_torch_host/ (never the
JAX package's build/libpbrs_host.so); when g++ fails, accel/bvh.py's NumPy
builder runs instead. Both give valid trees, and FlatBVH.builder says which
one made a tree. pybind11 isn't available, hence the C ABI.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "native" / "pbrs_host.cpp"
_OUT_DIR = _PKG.parent / "build" / "pbrs_tpu_torch_host"
_SO = _OUT_DIR / "libpbrs_host.so"

_lib = None
_tried = False


def _compile() -> bool:
    if _SO.exists() and _SO.stat().st_mtime >= _SRC.stat().st_mtime:
        return True
    _OUT_DIR.mkdir(parents=True, exist_ok=True)
    # Build beside the target and rename: test workers may build at once.
    tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o",
           str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except Exception as e:  # noqa: BLE001 — any failure means the NumPy builder
        log.warning("native host library build failed (%s); using NumPy", e)
        return False
    os.replace(tmp, _SO)
    return True


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _SRC.exists() or not _compile():
        return None
    lib = ctypes.CDLL(str(_SO))
    lib.bvh_build.restype = ctypes.c_void_p
    lib.bvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.bvh_counts.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.bvh_export.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_float)
    ] * 2 + [ctypes.POINTER(ctypes.c_int32)] * 5
    lib.bvh_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def build_bvh_native(prim_bbox_min, prim_bbox_max, max_leaf):
    """Native binned-SAH build; returns a FlatBVH or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from . import bvh as bvh_mod

    lo = np.ascontiguousarray(prim_bbox_min, np.float32)
    hi = np.ascontiguousarray(prim_bbox_max, np.float32)
    n = lo.shape[0]
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    handle = lib.bvh_build(
        lo.ctypes.data_as(fp), hi.ctypes.data_as(fp), n, int(max_leaf)
    )
    try:
        nn = ctypes.c_int32()
        npr = ctypes.c_int32()
        depth = ctypes.c_int32()
        lib.bvh_counts(handle, ctypes.byref(nn), ctypes.byref(npr),
                       ctypes.byref(depth))
        nn, npr = nn.value, npr.value
        bbox_min = np.empty((nn, 3), np.float32)
        bbox_max = np.empty((nn, 3), np.float32)
        is_leaf = np.empty(nn, np.int32)
        first = np.empty(nn, np.int32)
        count = np.empty(nn, np.int32)
        skip = np.empty(nn, np.int32)
        order = np.empty(npr, np.int32)
        lib.bvh_export(
            handle,
            bbox_min.ctypes.data_as(fp), bbox_max.ctypes.data_as(fp),
            is_leaf.ctypes.data_as(ip), first.ctypes.data_as(ip),
            count.ctypes.data_as(ip), skip.ctypes.data_as(ip),
            order.ctypes.data_as(ip),
        )
        return bvh_mod.FlatBVH(
            bbox_min=bbox_min, bbox_max=bbox_max, is_leaf=is_leaf,
            first=first, count=count, skip=skip, prim_order=order,
            depth=int(depth.value), builder="native",
        )
    finally:
        lib.bvh_free(handle)
