"""PLY mesh reader (ascii + binary little/big endian). A copy of
pbrs_tpu/scene/ply.py.

Replaces reference scene/src/plyloader.rs (whose tail is truncated in the
mounted snapshot — plyloader.rs:254-258; this implementation is complete).
Returns (positions [V,3], normals [V,3] | None, uvs [V,2] | None,
indices [F,3]) with polygon faces fan-triangulated
(plyloader.rs:150-190 semantics).
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(path: str):
    with open(path, "rb") as f:
        raw = f.read()

    # ---- header ---- [ref: scene/src/plyloader.rs:69-135]
    end = raw.index(b"end_header")
    end = raw.index(b"\n", end) + 1
    header = raw[:end].decode("ascii", "replace").splitlines()
    assert header[0].strip() == "ply", "not a PLY file"

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype) | ('list', idx_t, cnt_t, name)])
    for line in header[1:]:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[2], parts[1]))
        elif parts[0] in ("comment", "obj_info", "end_header"):
            pass

    body = raw[end:]
    vertices = {}
    faces = []

    if fmt == "ascii":
        tokens = body.split()
        ti = 0
        for name, count, props in elements:
            if name == "vertex":
                cols = {p[0]: [] for p in props}
                for _ in range(count):
                    for pname, _t in props:
                        cols[pname].append(float(tokens[ti]))
                        ti += 1
                vertices = {k: np.asarray(v, np.float32) for k, v in cols.items()}
            elif name == "face":
                for _ in range(count):
                    k = int(tokens[ti]); ti += 1
                    idx = [int(tokens[ti + j]) for j in range(k)]
                    ti += k
                    for j in range(1, k - 1):
                        faces.append((idx[0], idx[j], idx[j + 1]))
            else:
                # skip unknown element (ascii): consume its scalar props
                for _ in range(count):
                    for p in props:
                        ti += 1 if p[0] != "list" else 1 + int(tokens[ti])
    else:
        endian = "<" if fmt == "binary_little_endian" else ">"
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                dtype = np.dtype([
                    (pname, endian + _TYPES[t]) for pname, t in props
                ])
                arr = np.frombuffer(body, dtype, count=count, offset=off)
                off += dtype.itemsize * count
                vertices = {
                    pname: arr[pname].astype(np.float32) for pname, _ in props
                }
            elif name == "face":
                # variable-length lists: walk per face
                assert props and props[0][0] == "list"
                _, cnt_t, idx_t, _pname = props[0]
                cnt_dt = np.dtype(endian + _TYPES[cnt_t])
                idx_dt = np.dtype(endian + _TYPES[idx_t])
                for _ in range(count):
                    k = int(np.frombuffer(body, cnt_dt, 1, off)[0])
                    off += cnt_dt.itemsize
                    idx = np.frombuffer(body, idx_dt, k, off).astype(np.int64)
                    off += idx_dt.itemsize * k
                    for j in range(1, k - 1):
                        faces.append((int(idx[0]), int(idx[j]), int(idx[j + 1])))
            else:
                row = sum(
                    np.dtype(endian + _TYPES[t]).itemsize
                    for pname, t in props if pname != "list"
                )
                off += row * count

    positions = np.stack(
        [vertices["x"], vertices["y"], vertices["z"]], axis=1
    ).astype(np.float32)
    normals = None
    if "nx" in vertices:
        normals = np.stack(
            [vertices["nx"], vertices["ny"], vertices["nz"]], axis=1
        ).astype(np.float32)
    uvs = None
    for ukey, vkey in (("u", "v"), ("s", "t")):
        if ukey in vertices:
            uvs = np.stack([vertices[ukey], vertices[vkey]], axis=1).astype(
                np.float32
            )
            break
    indices = np.asarray(faces, np.int64).reshape(-1, 3)
    if normals is None:
        normals = compute_vertex_normals(positions, indices)
    return positions, normals, uvs, indices


def compute_vertex_normals(positions, indices):
    """Area-weighted vertex normals (segment-sum).
    [ref: geometry/src/lib.rs:16-32]"""
    p = positions
    i, j, k = indices[:, 0], indices[:, 1], indices[:, 2]
    face_n = np.cross(p[j] - p[i], p[k] - p[i])  # length ∝ 2·area
    normals = np.zeros_like(p)
    for col in (i, j, k):
        np.add.at(normals, col, face_n)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    return (normals / np.maximum(norm, 1e-20)).astype(np.float32)
