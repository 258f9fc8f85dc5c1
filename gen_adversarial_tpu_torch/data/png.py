"""PNG decoding and encoding with zlib and numpy (the GPU machine has no PIL).

The decoder reads 8-bit, non-interlaced files of color types 0 (L), 2 (RGB),
3 (palette), 4 (LA) and 6 (RGBA), with all five row filters; every chunk's
CRC is checked. Any other file (16-bit or low-bit-depth samples, Adam7
interlacing) raises a ValueError that names it. The encoder writes 8-bit
L, LA, RGB or RGBA files, every row with the Up filter.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples a pixel
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> color type, for the encoder


def _chunks(data: bytes, path):
    """(type, payload) of each chunk, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if pos + 12 + length > len(data):
            raise ValueError(f"{path}: truncated {kind!r} chunk at byte {pos}")
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: bad CRC of the {kind!r} chunk at byte {pos}")
        yield kind, payload
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: truncated before its IEND chunk")


def _paeth_row(raw: list, prior: list, bpp: int) -> list:
    out = raw
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _average_row(raw: list, prior: list, bpp: int) -> list:
    out = raw
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def _unfilter(data: bytes, height: int, stride: int, bpp: int, path) -> np.ndarray:
    rows = np.frombuffer(data, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f"{path}: image data has {rows.size} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = rows.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, raw = rows[y, 0], rows[y, 1:]
        if kind == 0:
            out[y] = raw
        elif kind == 1:  # Sub: a running sum of each sample mod 256
            out[y] = np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[y] = raw + prior
        elif kind == 3:  # Average
            out[y] = _average_row(raw.tolist(), prior.tolist(), bpp)
        elif kind == 4:  # Paeth
            out[y] = _paeth_row(raw.tolist(), prior.tolist(), bpp)
        else:
            raise ValueError(f"{path}: row {y} has filter type {kind}")
        prior = out[y]
    return out


def decode(path: str | Path) -> tuple[np.ndarray, int, np.ndarray | None]:
    """(pixels (H, W, samples) uint8, color type, palette (n, 3) uint8 or
    None). A palette image's pixels are its indices, as PIL's mode P."""
    data = Path(path).read_bytes()
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, compression, filtering, interlace = header
    if depth != 8 or color not in CHANNELS:
        raise ValueError(f"{path}: {depth}-bit samples of color type {color}; only 8-bit "
                         f"color types {sorted(CHANNELS)} are read")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG files are not read")
    if compression != 0 or filtering != 0:
        raise ValueError(f"{path}: unknown compression {compression} or filter method "
                         f"{filtering}")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: bad image data: {e}") from None
    c = CHANNELS[color]
    pixels = _unfilter(raw, height, width * c, c, path).reshape(height, width, c)
    return pixels, color, palette


def to_rgb(pixels: np.ndarray, color: int, palette: np.ndarray | None,
           path: str | Path = "") -> np.ndarray:
    """(H, W, 3) uint8, as PIL's convert('RGB'): gray replicated, alpha
    dropped, a palette looked up."""
    if color == 3:
        idx = pixels[..., 0]
        if idx.size and int(idx.max()) >= len(palette):
            raise ValueError(f"{path}: palette index beyond the palette")
        return palette[idx]
    if color in (0, 4):
        return np.repeat(pixels[..., :1], 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def read_rgb(path: str | Path) -> np.ndarray:
    """A PNG file as (H, W, 3) uint8 RGB."""
    return to_rgb(*decode(path), path)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode(pixels: np.ndarray) -> bytes:
    """A PNG file of (H, W) or (H, W, C) uint8 pixels, C in 1-4 (L, LA, RGB,
    RGBA)."""
    pixels = np.asarray(pixels)
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    if pixels.dtype != np.uint8 or pixels.ndim != 3 or pixels.shape[2] not in COLOR_TYPE:
        raise ValueError(f"cannot write {pixels.dtype} pixels of shape {pixels.shape} as PNG")
    h, w, c = pixels.shape
    rows = pixels.reshape(h, w * c)
    up = rows - np.concatenate([np.zeros((1, w * c), np.uint8), rows[:-1]])  # mod 256
    filtered = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, COLOR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6)) + _chunk(b"IEND", b""))


def write(path: str | Path, pixels: np.ndarray) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode(pixels))
