"""Minimal PNG encoder (zlib + stdlib only; a copy of
staticfusion_tpu/io/png.py, whose bytes it reproduces).

Write-side complement of the native decoder (csrc/io/png_decode.cpp):
uint8 gray/RGB/RGBA and uint16 gray (TUM depth PNGs are 16-bit
big-endian).  Used by the synthetic-dataset exporter and the rawlog
fixture writer.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 (H,W) / (H,W,3) / (H,W,4), or uint16 (H,W) -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype == np.uint16:
        if img.ndim != 2:
            raise ValueError("uint16 PNGs must be single-channel")
        depth, ctype = 16, 0
        raw = img.astype(">u2").tobytes()
        stride = img.shape[1] * 2
    elif img.dtype == np.uint8:
        if img.ndim == 2:
            ctype = 0
        elif img.ndim == 3 and img.shape[2] == 3:
            ctype = 2
        elif img.ndim == 3 and img.shape[2] == 4:
            ctype = 6
        else:
            raise ValueError(f"unsupported shape {img.shape}")
        depth = 8
        raw = img.tobytes()
        stride = img.shape[1] * (1 if img.ndim == 2 else img.shape[2])
    else:
        raise ValueError(f"unsupported dtype {img.dtype}")

    h = img.shape[0]
    # Filter byte 0 (None) per scanline.
    lines = b"".join(b"\x00" + raw[y * stride:(y + 1) * stride]
                     for y in range(h))
    ihdr = struct.pack(">IIBBBBB", img.shape[1], h, depth, ctype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(lines, 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
