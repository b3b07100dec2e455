"""Image I/O: PNG and a self-contained OpenEXR writer/reader.

Copied from pbrs_tpu/io/image.py (host-side NumPy; ``to_u8`` from
pbrs_tpu/radiometry.py). ``write_exr`` emits uncompressed single-part
scanline OpenEXR 2.0 for float32 RGB, readable by ``read_exr``. The PNG
reader and writer use zlib and NumPy only (the JAX package reads and writes
PNGs with PIL): ``read_png`` decodes 8-bit, non-interlaced grey, grey+alpha,
RGB and RGBA images with filter types 0-4.
"""

from __future__ import annotations

import struct
import zlib

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


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray, gamma: bool = True) -> None:
    """sqrt-gamma + u8 RGB PNG (filter type 0 on every row)."""
    img = np.asarray(image, np.float32)
    if gamma:
        img = np.sqrt(np.maximum(img, 0.0))
    u8 = to_u8(img)
    h, w, _ = u8.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), u8.reshape(h, 3 * w)],
                         axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(_PNG_MAGIC)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel


def _paeth_row(line, prior, bpp):
    """Undo the Paeth filter of one row (bytes, in place)."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def _average_row(line, prior, bpp):
    """Undo the Average filter of one row (bytes, in place)."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prior[i]) >> 1)) & 0xFF


def read_png(path: str) -> np.ndarray:
    """Decode a PNG into a uint8 [H, W, C] array (C = 1, 2, 3 or 4)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(raw):
        (length,) = struct.unpack_from(">I", raw, pos)
        tag = raw[pos + 4:pos + 8]
        data = raw[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour "
                         f"type {ctype}, interlace {interlace}); read_png "
                         "takes 8-bit non-interlaced grey/RGB(A)")
    bpp = _PNG_CHANNELS[ctype]
    stride = w * bpp
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum along the row, per channel
            cur = (np.cumsum(line.reshape(w, bpp).astype(np.int64), axis=0)
                   & 0xFF).astype(np.uint8).reshape(stride)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            (_average_row if kind == 3 else _paeth_row)(buf, prior.tobytes(),
                                                        bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: bad filter type {kind} in row {y}")
        out[y] = cur
        prior = out[y]
    return out.reshape(h, w, bpp)


def read_png_rgb(path: str) -> np.ndarray:
    """A PNG as float32 linear [H, W, 3] in [0, 1]: grey is replicated and
    alpha dropped, as PIL's ``convert("RGB")`` does."""
    px = read_png(path)
    if px.shape[2] in (1, 2):
        px = np.repeat(px[:, :, :1], 3, axis=2)
    return px[:, :, :3].astype(np.float32) / 255.0
