"""Image output: PNG (via PIL) and a self-contained OpenEXR writer/reader.

Copied from pbrs_tpu/io/image.py (host-side NumPy; ``to_u8`` from
pbrs_tpu/radiometry.py). ``write_exr`` emits uncompressed single-part
scanline OpenEXR 2.0 for float32 RGB, readable by ``read_exr``.
"""

from __future__ import annotations

import struct

import numpy as np

_EXR_MAGIC = 0x01312F76
_FLOAT = 2  # OpenEXR pixel type


def _attr(name: str, type_name: str, payload: bytes) -> bytes:
    return (name.encode() + b"\0" + type_name.encode() + b"\0"
            + struct.pack("<i", len(payload)) + payload)


def to_u8(c):
    """Saturating [0,1] -> u8."""
    return np.clip(np.asarray(c) * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)


def write_exr(path: str, image: np.ndarray) -> None:
    """Write [H,W,3] float32 linear RGB as uncompressed scanline EXR."""
    img = np.asarray(image, np.float32)
    h, w, _ = img.shape

    chlist = b""
    for name in (b"B", b"G", b"R"):  # alphabetical, required by the format
        chlist += name + b"\0" + struct.pack("<iiii", _FLOAT, 0, 1, 1)
    chlist += b"\0"

    header = b""
    header += _attr("channels", "chlist", chlist)
    header += _attr("compression", "compression", b"\0")  # none
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", b"\0")  # increasing Y
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"  # end of header

    preamble = struct.pack("<Ii", _EXR_MAGIC, 2) + header
    line_bytes = 8 + 3 * 4 * w  # y + size prefix + 3 channels of float32
    data_start = len(preamble) + 8 * h
    offsets = [data_start + i * line_bytes for i in range(h)]
    with open(path, "wb") as f:
        f.write(preamble)
        f.write(struct.pack(f"<{h}Q", *offsets))
        for y in range(h):
            f.write(struct.pack("<ii", y, 3 * 4 * w))
            f.write(img[y, :, 2].tobytes())
            f.write(img[y, :, 1].tobytes())
            f.write(img[y, :, 0].tobytes())


def read_exr(path: str) -> np.ndarray:
    """Read an EXR written by `write_exr` (uncompressed float RGB)."""
    with open(path, "rb") as f:
        raw = f.read()
    magic, _version = struct.unpack_from("<Ii", raw, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    pos = 8
    attrs = {}
    while raw[pos] != 0:
        name_end = raw.index(b"\0", pos)
        name = raw[pos:name_end].decode()
        pos = raw.index(b"\0", name_end + 1) + 1
        (size,) = struct.unpack_from("<i", raw, pos)
        pos += 4
        attrs[name] = raw[pos:pos + size]
        pos += size
    pos += 1
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    pos += 8 * h  # skip offset table
    img = np.zeros((h, w, 3), np.float32)
    for _ in range(h):
        y, size = struct.unpack_from("<ii", raw, pos)
        pos += 8
        row = np.frombuffer(raw, np.float32, count=3 * w, offset=pos)
        pos += size
        img[y, :, 2] = row[:w]
        img[y, :, 1] = row[w:2 * w]
        img[y, :, 0] = row[2 * w:]
    return img


def write_png(path: str, image: np.ndarray, gamma: bool = True) -> None:
    """sqrt-gamma + u8 PNG."""
    from PIL import Image

    img = np.asarray(image, np.float32)
    if gamma:
        img = np.sqrt(np.maximum(img, 0.0))
    Image.fromarray(to_u8(img), "RGB").save(path)
