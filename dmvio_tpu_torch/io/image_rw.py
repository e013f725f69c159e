"""Minimal dependency-free PNG image writing (+ reading via the native
loader or a pure-python fallback).

Copy of dmvio_tpu/io/image_rw.py (NumPy only), the counterpart of DM-VIO's
IOWrapper image R/W (src/dso/IOWrapper/ImageRW.h, OpenCV-backed with dummy
fallbacks ImageRW_dummy.cpp): artifacts are written by the headless viewer
and the dataset saver without any OpenCV/GUI dependency. Beyond the
reference it writes and reads 16-bit grayscale (the vignette image of a
photometric calibration), so that the port needs no imaging package to
write or read a dataset.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 grayscale [H, W] or RGB [H, W, 3], or uint16 grayscale
    [H, W], as PNG."""
    a = np.asarray(img)
    bitdepth = 8
    if a.dtype == np.uint16 and a.ndim == 2:
        bitdepth = 16
    elif a.dtype != np.uint8:
        a = np.clip(a, 0, 255).astype(np.uint8)
    if a.ndim == 2:
        color_type = 0
        raw = (a.astype(">u2").view(np.uint8).reshape(a.shape[0], -1)
               if bitdepth == 16 else a[:, :, None])
    elif a.ndim == 3 and a.shape[2] == 3:
        color_type = 2
        raw = a
    else:
        raise ValueError(f"unsupported image shape {a.shape}")
    h, w = a.shape[:2]
    # Filter byte 0 (None) per scanline.
    lines = np.concatenate(
        [np.zeros((h, 1), np.uint8), raw.reshape(h, -1)], axis=1)
    compressed = zlib.compress(lines.tobytes(), 6)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, bitdepth, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", compressed))
        f.write(chunk(b"IEND", b""))


def read_png_gray(path: str) -> np.ndarray:
    """Read a PNG as grayscale float32 [H, W] in [0, 255] (16-bit values
    divided by 256, as the native decoder does)."""
    from dmvio_tpu_torch.io import native

    img = native.decode_png(path) if native.available() else None
    if img is not None:
        return img
    # Pure-python fallback: 8-bit gray / RGB, filter types 0-4.
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = bitdepth = ctype = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, bitdepth, ctype = struct.unpack(">IIBB", payload[:10])
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    if bitdepth not in (8, 16):
        raise ValueError(f"unsupported bit depth {bitdepth}")
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    bpp = nch * bitdepth // 8
    stride = w * bpp
    raw = raw.reshape(h, stride + 1)
    filt = raw[:, 0]
    out = np.zeros((h, stride), np.int32)
    for y in range(h):
        line = raw[y, 1:].astype(np.int32)
        ft = filt[y]
        prev = out[y - 1] if y > 0 else np.zeros(stride, np.int32)
        if ft == 0:
            out[y] = line
        elif ft == 2:                      # Up
            out[y] = (line + prev) & 0xFF
        else:                              # Sub/Average/Paeth need a scan
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + b) // 2
                else:                      # Paeth
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else \
                        (b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
            out[y] = cur
    if bitdepth == 16:
        px = (out[:, 0::2] * 256 + out[:, 1::2]).astype(np.float32) / 256.0
        px = px.reshape(h, w, nch)
    else:
        px = out.reshape(h, w, nch).astype(np.float32)
    if nch == 1:
        return px[:, :, 0]
    if nch == 2:
        return px[:, :, 0]
    return 0.299 * px[:, :, 0] + 0.587 * px[:, :, 1] + 0.114 * px[:, :, 2]


def colormap_jet(x: np.ndarray) -> np.ndarray:
    """Map [0, 1] floats to RGB uint8 (jet-like, vectorized)."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0, 1)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0, 1)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)
