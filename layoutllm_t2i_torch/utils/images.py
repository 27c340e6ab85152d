"""Image grids, the PNG writer and its reader (layoutllm_t2i_tpu/utils/
images.py; the reference ImageCaptionSaver, trainer_combined_layout.py:
37-67: a row-major grid PNG plus a captions txt).

PNGs are written by a small writer of its own (zlib + struct, filter 0 on
every row, 8-bit RGB): the same pixels the JAX package's Pillow writer
stores, with no imaging library needed where the port runs. ``read_png``
reads back exactly that form (the RL data's images where Pillow is
absent); any other PNG raises ``PNGFormatError``. ``decode_rgb`` and
``read_rgb`` take that route for such a PNG and Pillow's for any other
file, the format deciding which.
"""
from __future__ import annotations

import io
import struct
import zlib
from typing import Optional, Sequence

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def make_grid(images01: np.ndarray, ncols: int = 4, pad: int = 2) -> np.ndarray:
    """(N, H, W, 3) float [0,1] -> uint8 grid image."""
    imgs = (np.clip(np.asarray(images01), 0, 1) * 255).astype(np.uint8)
    n, h, w, c = imgs.shape
    ncols = min(ncols, n)
    nrows = (n + ncols - 1) // ncols
    grid = np.full(
        (nrows * (h + pad) - pad, ncols * (w + pad) - pad, c), 255, np.uint8
    )
    for i, im in enumerate(imgs):
        r, cidx = divmod(i, ncols)
        grid[r * (h + pad):r * (h + pad) + h,
             cidx * (w + pad):cidx * (w + pad) + w] = im
    return grid


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes_uint8(arr: np.ndarray) -> bytes:
    """(H, W, 3) uint8 pixels -> PNG bytes."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"want an (H, W, 3) uint8 RGB image, got "
                         f"{arr.dtype} {arr.shape}")
    h, w, _ = arr.shape
    # each scanline: filter type 0 (none), then its bytes
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)],
                         axis=1).tobytes()
    # width, height, bit depth 8, colour type 2 (RGB), deflate, filters,
    # no interlace
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b""))


def png_bytes(img01: np.ndarray) -> bytes:
    """(H, W, 3) floats in [0, 1] -> PNG bytes, the pixels
    ``(clip(img, 0, 1) * 255).astype(uint8)``."""
    arr = np.asarray(img01)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"want an (H, W, 3) RGB image, got {arr.shape}")
    return png_bytes_uint8((np.clip(arr, 0, 1) * 255).astype(np.uint8))


class PNGFormatError(ValueError):
    """A well-formed PNG in a form ``read_png`` does not decode (another
    bit depth or colour type, interlacing, a row filter other than 0)."""


def read_png(png: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of an 8-bit RGB PNG without interlacing whose
    rows all use filter 0, as ``png_bytes_uint8`` writes it; every chunk's
    CRC is checked. A damaged file raises ValueError, another form of PNG
    PNGFormatError."""
    if png[:8] != PNG_SIGNATURE:
        raise ValueError("png: not a PNG")
    pos, idat, head = 8, b"", None
    while pos < len(png):
        n, kind = struct.unpack(">I4s", png[pos:pos + 8])
        data = png[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", png[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(kind + data) & 0xFFFFFFFF:
            raise ValueError(f"png: bad CRC in the PNG's {kind!r} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat += data
        elif kind == b"IEND":
            break
    if head is None:
        raise ValueError("png: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = head
    if (depth, colour, interlace) != (8, 2, 0):
        raise PNGFormatError(f"png: not 8-bit RGB without interlace: {head}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise PNGFormatError("png: a row uses a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def decode_rgb(data: bytes, name: str = "image") -> np.ndarray:
    """(H, W, 3) uint8 pixels of an encoded image: ``read_png`` for an 8-bit
    RGB PNG with unfiltered rows, Pillow's ``convert("RGB")`` for any other
    file (as the JAX package's datasets decode). Without Pillow any other
    file raises RuntimeError naming ``name`` and the package; a damaged PNG
    raises ValueError."""
    try:
        return read_png(data)
    except PNGFormatError:
        pass
    except ValueError:
        if data[:8] == PNG_SIGNATURE:
            raise
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(
            f"{name}: only 8-bit RGB PNGs with unfiltered rows are read "
            "without Pillow, which is not installed") from exc
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"))


def read_rgb(path: str) -> np.ndarray:
    """``decode_rgb`` of the file at ``path``."""
    with open(path, "rb") as f:
        return decode_rgb(f.read(), path)


def save_png(arr_uint8: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes_uint8(arr_uint8))


def save_image_grid(images01: np.ndarray, path: str,
                    captions: Optional[Sequence[str]] = None,
                    ncols: int = 4) -> None:
    """The grid of make_grid as a PNG at ``path``, and the captions, one a
    line, beside it as ``.txt``."""
    save_png(make_grid(images01, ncols), path)
    if captions is not None:
        with open(path.rsplit(".", 1)[0] + ".txt", "w") as f:
            f.write("\n".join(captions))
