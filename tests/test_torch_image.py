"""The port's PNG reader and writer (io/image.py, zlib + NumPy, no PIL)
against PIL, and its image-texture atlas (textures/textures.py) against
pbrs_tpu's: the atlas arrays and eval_texture on seeded uv."""

import os
import struct
import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from pbrs_tpu.textures import textures as jtex
from pbrs_tpu_torch.io import image as io_image
from pbrs_tpu_torch.textures import textures as ttex

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PNGS = ("env_window.png", "wood.png")


@pytest.mark.parametrize("name", PNGS)
def test_committed_pngs_decode_as_pil_does(name):
    path = os.path.join(REPO, "scenes", "interior", "textures", name)
    want = np.asarray(Image.open(path))
    got = io_image.read_png(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        io_image.read_png_rgb(path),
        np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0)


def _filter_row(kind, line, prior, bpp):
    """Apply PNG filter `kind` to one row (the encoder's side)."""
    line = line.astype(np.int64)
    prior = prior.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
    up_left = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(line)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prior
    elif kind == 3:
        pred = (left + prior) >> 1
    else:
        p = left + prior - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - up_left)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prior, up_left))
    return ((line - pred) & 0xFF).astype(np.uint8)


def _write_png(path, px, ctype):
    h, w, bpp = px.shape
    rows, prior = [], np.zeros(w * bpp, np.uint8)
    for y in range(h):
        kind = y % 5
        line = px[y].reshape(-1)
        rows.append(bytes([kind]) + _filter_row(kind, line, prior,
                                                bpp).tobytes())
        prior = line

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                           0)))
        f.write(chunk(b"IDAT", zlib.compress(b"".join(rows))))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,channels", [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_every_filter_type_and_colour_type(tmp_path, ctype, channels):
    """Rows filtered with types 0-4 in turn decode to the pixels, as PIL
    reads them."""
    px = np.random.default_rng(ctype).integers(0, 256, (13, 11, channels),
                                               dtype=np.uint8)
    path = str(tmp_path / "f.png")
    _write_png(path, px, ctype)
    got = io_image.read_png(path)
    np.testing.assert_array_equal(got, px)
    pil = np.asarray(Image.open(path))
    np.testing.assert_array_equal(got.reshape(pil.shape), pil)


def test_write_png_reads_back(tmp_path):
    img = np.random.default_rng(4).random((9, 7, 3)).astype(np.float32)
    path = str(tmp_path / "w.png")
    io_image.write_png(path, img)
    want = io_image.to_u8(np.sqrt(img))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
    np.testing.assert_array_equal(io_image.read_png(path), want)


def test_unsupported_png_raises(tmp_path):
    path = str(tmp_path / "i.png")
    _write_png(path, np.zeros((2, 2, 3), np.uint8), 2)
    raw = bytearray(open(path, "rb").read())
    raw[8 + 8 + 12] = 1  # interlace method in IHDR
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="interlace"):
        io_image.read_png(path)


def _textures(mod):
    rng = np.random.default_rng(5)
    b = mod.TextureBuilder()
    b.add_solid((0.2, 0.4, 0.6))
    b.add_image(rng.random((8, 8, 3)).astype(np.float32))
    b.add_checker((0.7, 0.7, 0.2), (0.1, 0.1, 0.4))
    b.add_image(rng.random((5, 13, 3)).astype(np.float32))
    b.add_image_file(os.path.join(REPO, "scenes", "interior", "textures",
                                  "wood.png"))
    return b.build()


def test_atlas_tables_match_reference():
    jt, tt = _textures(jtex), _textures(ttex)
    for name in ("kind", "color_a", "color_b", "freq", "img_offset", "img_w",
                 "img_h", "atlas"):
        got, want = getattr(tt, name).numpy(), np.asarray(getattr(jt, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert tt.atlas.shape[0] == 8 * 8 + 5 * 13 + 256 * 256


def test_eval_texture_matches_reference():
    """Every kind on seeded ids, uv (outside [0, 1] too) and positions."""
    jt, tt = _textures(jtex), _textures(ttex)
    rng = np.random.default_rng(6)
    n = 4096
    tid = rng.integers(-1, 5, n).astype(np.int32)
    uv = rng.uniform(-0.2, 1.2, (n, 2)).astype(np.float32)
    pos = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    want = np.asarray(jtex.eval_texture(jt, jnp.asarray(tid), jnp.asarray(uv),
                                        jnp.asarray(pos)))
    got = ttex.eval_texture(tt, torch.from_numpy(tid), torch.from_numpy(uv),
                            torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want[tid == 4] > 0).any()  # the wood texels are read
