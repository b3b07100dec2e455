"""Affine transforms as 4x4 matrices, host-side (NumPy).

Copied from pbrs_tpu/geometry/transform.py (the host-side builders): the
scene compiler bakes instance transforms into world-space primitives on
the host, so the port needs no device-side appliers yet.
"""

from __future__ import annotations

import numpy as np


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


def translate(v) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(v, np.float32)
    return m


def scale(s) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    s = np.broadcast_to(np.asarray(s, np.float32), (3,))
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def _rot(axis: int, deg: float) -> np.ndarray:
    th = np.radians(deg)
    c, s = np.cos(th), np.sin(th)
    m = np.eye(4, dtype=np.float32)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def rotate_x(deg: float) -> np.ndarray:
    return _rot(0, deg)


def rotate_y(deg: float) -> np.ndarray:
    return _rot(1, deg)


def rotate_z(deg: float) -> np.ndarray:
    return _rot(2, deg)


def rotate_axis_angle(axis, deg: float) -> np.ndarray:
    """Rodrigues rotation about an arbitrary axis."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    th = np.radians(deg)
    k = np.array(
        [
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ]
    )
    r = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * (k @ k)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r.astype(np.float32)
    return m


def look_at(eye, target, up) -> np.ndarray:
    """PBRT-style LookAt camera-to-world matrix (left-handed, z forward)."""
    eye = np.asarray(eye, np.float64)
    forward = np.asarray(target, np.float64) - eye
    forward = forward / np.linalg.norm(forward)
    right = np.cross(np.asarray(up, np.float64), forward)
    right = right / np.linalg.norm(right)
    up_adj = np.cross(forward, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, up_adj, forward, eye
    return m


def compose(*mats) -> np.ndarray:
    """compose(A, B, ...) applies ... then B then A (matrix product order)."""
    out = np.eye(4, dtype=np.float32)
    for m in mats:
        out = out @ np.asarray(m, np.float32)
    return out


def inverse(m) -> np.ndarray:
    return np.linalg.inv(np.asarray(m, np.float64)).astype(np.float32)
