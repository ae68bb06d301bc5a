"""Image I/O: PNG write and read, JPEG read, Radiance HDR read, and the
bilinear resampler of the environment map's importance table.

The port's own copy of the numpy functions of
``pathtracer_tpu/utils/image.py`` (PNG via zlib, HDR via a small RLE
decoder). Only ``read_jpeg`` needs more than numpy: it imports Pillow
when it is called.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, rgb8: np.ndarray) -> None:
    """Write (H, W, 3) RGB or (H, W, 4) RGBA uint8 as PNG."""
    h, w, c = rgb8.shape
    assert c in (3, 4) and rgb8.dtype == np.uint8
    color_type = 2 if c == 3 else 6

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + rgb8[y].tobytes() for y in range(h))
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR",
                   struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for 8-bit RGB/RGBA: (H, W, 3) or (H, W, 4)
    uint8. Every filter type (none, sub, up, average, Paeth)."""
    with open(path, "rb") as f:
        return _decode_png(f.read())


def _decode_png(data: bytes) -> np.ndarray:
    """``read_png`` on the file's bytes."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = bit_depth = color_type = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, bit_depth, color_type = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + ln
    assert bit_depth == 8 and color_type in (2, 6)
    nch = 3 if color_type == 2 else 4
    raw = zlib.decompress(idat)
    stride = w * nch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ft = raw[pos]
        row = np.frombuffer(raw[pos + 1:pos + 1 + stride],
                            np.uint8).astype(np.int32)
        pos += 1 + stride
        if ft == 0:
            cur = row
        elif ft == 1:
            cur = row.copy()
            for x in range(nch, stride):
                cur[x] = (cur[x] + cur[x - nch]) & 0xFF
        elif ft == 2:
            cur = (row + prev) & 0xFF
        elif ft == 3:
            cur = row.copy()
            for x in range(stride):
                left = cur[x - nch] if x >= nch else 0
                cur[x] = (cur[x] + (left + prev[x]) // 2) & 0xFF
        elif ft == 4:
            cur = row.copy()
            for x in range(stride):
                a = cur[x - nch] if x >= nch else 0
                b = prev[x]
                c = prev[x - nch] if x >= nch else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"unsupported PNG filter {ft}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, nch)


def read_jpeg(path_or_bytes) -> np.ndarray:
    """Decode a JPEG (a path or the file's bytes) -> (H, W, 3) uint8 RGB
    through Pillow, imported here and nowhere at module load: glTF's
    other mandated image format; grayscale and CMYK convert to RGB."""
    import io

    from PIL import Image

    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) \
        else path_or_bytes
    with Image.open(src) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def decode_image_bytes(data: bytes, mime: str = "") -> np.ndarray:
    """Decode an embedded image buffer (PNG or JPEG) -> (H, W, 3|4)
    uint8, dispatching on the magic bytes, not the (often wrong) glTF
    mimeType."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return _decode_png(data)
    if data[:2] == b"\xff\xd8":
        return read_jpeg(data)
    raise ValueError(f"unsupported image format (mime={mime!r}, "
                     f"magic={data[:4]!r})")


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr (RGBE) file → (H, W, 3) float32 linear."""
    with open(path, "rb") as f:
        data = f.read()
    # header
    end = data.find(b"\n\n")
    if end < 0:
        raise ValueError("bad hdr header")
    header = data[:end].decode("latin-1")
    if not (header.startswith("#?RADIANCE") or header.startswith("#?RGBE")):
        raise ValueError("not a radiance file")
    pos = end + 2
    nl = data.find(b"\n", pos)
    dims = data[pos:nl].decode("latin-1").split()
    # expect "-Y H +X W"
    if len(dims) != 4 or dims[0] != "-Y" or dims[2] != "+X":
        raise ValueError(f"unsupported hdr orientation {dims}")
    h, w = int(dims[1]), int(dims[3])
    pos = nl + 1
    rgbe = np.zeros((h, w, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    for y in range(h):
        # new-style RLE scanline?
        if (pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2
                and ((data[pos + 2] << 8) | data[pos + 3]) == w):
            pos += 4
            for ch in range(4):
                x = 0
                while x < w:
                    count = data[pos]
                    pos += 1
                    if count > 128:  # run
                        rgbe[y, x:x + count - 128, ch] = data[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x:x + count, ch] = buf[pos:pos + count]
                        pos += count
                        x += count
        else:  # flat scanline
            row = buf[pos:pos + 4 * w].reshape(w, 4)
            rgbe[y] = row
            pos += 4 * w
    mantissa = rgbe[..., :3].astype(np.float32)
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0,
                     np.ldexp(1.0, exp - 136)).astype(np.float32)
    return mantissa * scale[..., None] + 0.0


def bilinear_sample(img: np.ndarray, us: np.ndarray, vs: np.ndarray) -> np.ndarray:
    """Sample a (H, W) image at the outer grid us × vs (both in [0,1])."""
    h, w = img.shape
    x = us * w - 0.5
    y = vs * h - 0.5
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    fx = x - x0
    fy = y - y0
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    top = img[y0c[:, None], x0c[None, :]] * (1 - fx)[None, :] + \
        img[y0c[:, None], x1c[None, :]] * fx[None, :]
    bot = img[y1c[:, None], x0c[None, :]] * (1 - fx)[None, :] + \
        img[y1c[:, None], x1c[None, :]] * fx[None, :]
    return top * (1 - fy)[:, None] + bot * fy[:, None]
