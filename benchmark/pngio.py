"""PNG files of 8-bit gray or RGBA pixels, written and read with zlib alone.

The benchmark writes its datasets with ``write_png`` (filter 0 on every row,
zlib level 6) and the plain reference reads them back with ``read_png``,
which takes only what ``write_png`` writes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOUR = {1: 0, 4: 6}  # channels -> PNG colour type (gray, RGBA)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """(h, w) gray or (h, w, 4) RGBA uint8 -> a PNG file."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * channels)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOUR[channels], 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, 6))
                 + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """A file of ``write_png`` -> (h, w) or (h, w, 4) uint8."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    w, h, depth, colour = header[:4]
    channels = {0: 1, 6: 4}[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w * channels + 1)
    if depth != 8 or raw[:, 0].any():
        raise ValueError(f"{path}: not a file of write_png")
    px = raw[:, 1:].reshape(h, w, channels)
    return px[..., 0] if channels == 1 else px
