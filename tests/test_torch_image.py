"""The port's image decoders against the JAX package's.

``read_png`` must give the reference's pixels exactly: on the eight PNG
images embedded in the two glTF assets, and on small synthetic PNGs
written here with each of the five row filters (none, sub, up, average,
Paeth), in RGB and RGBA. ``decode_image_bytes`` dispatches on the magic
bytes; ``read_jpeg`` decodes through Pillow, as the reference does.
"""

import io
import struct
import zlib

import numpy as np
import pytest

from pathtracer_tpu.utils import image as jimage
from pathtracer_tpu_torch.scene.gltf import GLTFFile
from pathtracer_tpu_torch.utils import image

ASSETS = ("data/classroom_proc.glb", "data/sponza_proc.glb")


def _embedded_images():
    """(asset, image index, bytes) of every image in the two GLBs."""
    out = []
    for path in ASSETS:
        gf = GLTFFile(path)
        for i, img in enumerate(gf.json["images"]):
            bv = gf.json["bufferViews"][img["bufferView"]]
            data = gf.buffer(bv["buffer"])
            start = bv.get("byteOffset", 0)
            out.append((path, i, data[start:start + bv["byteLength"]]))
    return out


EMBEDDED = _embedded_images()


def test_the_assets_hold_eight_pngs():
    assert len(EMBEDDED) == 8
    assert all(blob[:8] == b"\x89PNG\r\n\x1a\n" for _, _, blob in EMBEDDED)


@pytest.mark.parametrize("k", range(8))
def test_read_png_matches_reference_on_the_assets(k, tmp_path):
    _, _, blob = EMBEDDED[k]
    path = tmp_path / "img.png"
    path.write_bytes(blob)
    got = image.read_png(str(path))
    want = jimage.read_png(str(path))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(image.decode_image_bytes(blob), want)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _encode_png(pixels: np.ndarray, filters) -> bytes:
    """An 8-bit RGB / RGBA PNG whose row y uses filter filters[y]."""
    h, w, nch = pixels.shape
    rows = pixels.reshape(h, w * nch).astype(np.int64)
    raw = b""
    prev = np.zeros(w * nch, np.int64)
    for y in range(h):
        cur = rows[y]
        out = np.zeros_like(cur)
        for x in range(w * nch):
            a = cur[x - nch] if x >= nch else 0
            b = prev[x]
            c = prev[x - nch] if x >= nch else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][filters[y]]
            out[x] = (cur[x] - pred) & 0xFF
        raw += bytes([filters[y]]) + out.astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                         2 if nch == 3 else 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("nch", [3, 4])
@pytest.mark.parametrize("filters", [[0] * 6, [1] * 6, [2] * 6, [3] * 6,
                                     [4] * 6, [0, 1, 2, 3, 4, 4]])
def test_read_png_filter_types(filters, nch, tmp_path):
    pixels = np.random.default_rng(sum(filters) + nch).integers(
        0, 256, (6, 7, nch), dtype=np.uint8)
    blob = _encode_png(pixels, filters)
    path = tmp_path / "f.png"
    path.write_bytes(blob)
    got = image.read_png(str(path))
    np.testing.assert_array_equal(got, pixels)
    np.testing.assert_array_equal(got, jimage.read_png(str(path)))
    np.testing.assert_array_equal(image.decode_image_bytes(blob), got)


def test_read_png_round_trips_write_png(tmp_path):
    pixels = np.random.default_rng(3).integers(0, 256, (9, 5, 4),
                                               dtype=np.uint8)
    image.write_png(str(tmp_path / "w.png"), pixels)
    np.testing.assert_array_equal(image.read_png(str(tmp_path / "w.png")),
                                  pixels)


def test_decode_image_bytes_dispatches_on_magic_bytes():
    with pytest.raises(ValueError, match="unsupported image format"):
        image.decode_image_bytes(b"GIF89a....", "image/png")
    with pytest.raises(ValueError, match="unsupported image format"):
        jimage.decode_image_bytes(b"GIF89a....", "image/png")


def _jpeg_bytes():
    pil = pytest.importorskip("PIL.Image")
    img = np.zeros((16, 16, 3), np.uint8)
    img[:8, :8] = [255, 0, 0]
    img[8:, 8:] = [0, 0, 255]
    buf = io.BytesIO()
    pil.fromarray(img).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def test_read_jpeg_matches_reference(tmp_path):
    blob = _jpeg_bytes()
    path = tmp_path / "x.jpg"
    path.write_bytes(blob)
    want = jimage.read_jpeg(blob)
    for got in (image.read_jpeg(blob), image.read_jpeg(str(path)),
                image.decode_image_bytes(blob, "image/png")):
        assert got.shape == (16, 16, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert want[2, 2, 0] > 200 and want[12, 12, 2] > 200
