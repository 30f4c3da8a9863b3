"""8-bit grayscale PNG encode/decode on zlib and struct alone.

EuRoC and TUM-VI ship their camera frames as 8-bit grayscale PNGs; this
is all the image I/O the loaders and the mini-ASL writer need, without
an imaging library. Non-interlaced greyscale (colour type 0, bit depth
8) only; anything else raises ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_gray(img: np.ndarray) -> bytes:
    """(H, W) uint8 -> PNG bytes (every scanline with filter type 0)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"expected a 2-D image, got shape {img.shape}")
    h, w = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth_row(line: np.ndarray, prev: np.ndarray) -> np.ndarray:
    out = np.zeros_like(line, dtype=np.int32)
    a = 0
    for x in range(line.shape[0]):
        b = int(prev[x])
        c = int(prev[x - 1]) if x else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        a = (int(line[x]) + pred) & 0xFF
        out[x] = a
    return out.astype(np.uint8)


def _average_row(line: np.ndarray, prev: np.ndarray) -> np.ndarray:
    out = np.zeros_like(line)
    a = 0
    for x in range(line.shape[0]):
        a = (int(line[x]) + ((a + int(prev[x])) >> 1)) & 0xFF
        out[x] = a
    return out


def decode_gray(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) uint8."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if (depth, colour, interlace) != (8, 0, 0):
        raise ValueError(f"only 8-bit non-interlaced greyscale PNG is "
                         f"supported (depth {depth}, colour type {colour}, "
                         f"interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:h * (w + 1)].reshape(h, w + 1)
    out = np.empty((h, w), np.uint8)
    prev = np.zeros(w, np.uint8)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:]
        if kind == 0:
            row = line
        elif kind == 1:      # Sub: running sum along the row, mod 256
            row = np.cumsum(line, dtype=np.uint8)
        elif kind == 2:      # Up
            row = line + prev
        elif kind == 3:      # Average
            row = _average_row(line, prev)
        elif kind == 4:      # Paeth
            row = _paeth_row(line, prev)
        else:
            raise ValueError(f"bad PNG filter type {kind} on row {y}")
        out[y] = row
        prev = out[y]
    return out


def read_gray(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_gray(f.read())


def write_gray(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_gray(img))
