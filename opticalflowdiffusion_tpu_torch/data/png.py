"""PNG and binary PPM without cv2 or PIL: the port's one image reader and
writer.

``imread`` returns what the JAX readers get from ``cv2.imread`` after their
BGR -> RGB flip: an (H, W, 3) array in RGB order.  By default (cv2's
``IMREAD_COLOR``) grey is replicated, alpha is dropped and 16-bit samples
are reduced to 8 bits as libpng's ``png_set_strip_16`` reduces them (the
high byte); ``anydepth=True`` is ``IMREAD_ANYDEPTH | IMREAD_COLOR`` and
keeps 16 bits (the KITTI flow PNG).  PNG: bit depths 8 and 16, colour types
grey, grey + alpha, RGB and RGBA, all five row filters; a palette, a bit
depth below 8, interlacing or a bad chunk CRC raises.  PPM: binary ``P6``
with a maximum of 255.

The row filters are undone by the host helper (``data/host.py``: Average
and Paeth need each byte's left neighbour after its reconstruction);
``unfilter_plain`` is its numpy version.  ``encode_png`` writes 8- or
16-bit grey, RGB or RGBA with a chosen filter per row (default: every row
unfiltered); ``write_ppm`` writes P6.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from . import host

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        crc = data[pos + 8 + length: pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends without IEND")


def decode_png(data: bytes) -> np.ndarray:
    """The samples of a PNG as stored: (H, W, C) uint8 or uint16 (native
    byte order), C = 1 (grey), 2 (grey + alpha), 3 (RGB) or 4 (RGBA)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    W, H, depth, color, compression, filt, interlace = header
    if color not in CHANNELS:
        raise ValueError(f"PNG colour type {color} is not supported (grey, grey + alpha, RGB, "
                         "RGBA only)")
    if depth not in (8, 16):
        raise ValueError(f"PNG bit depth {depth} is not supported (8 and 16 only)")
    if interlace != 0:
        raise ValueError("interlaced PNG is not supported")
    if compression != 0 or filt != 0:
        raise ValueError(f"PNG compression {compression} / filter method {filt} is unknown")
    C = CHANNELS[color]
    bpp = C * depth // 8
    rows = host.png_unfilter(np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8),
                             H, W * bpp, bpp)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(H, W, C)
    return rows.reshape(H, W, C)


def unfilter_plain(raw, height: int, stride: int, bpp: int) -> np.ndarray:
    """numpy version of ``host.png_unfilter``: None, Sub and Up a row at a
    time, Average and Paeth a pixel at a time."""
    raw = np.frombuffer(raw, np.uint8) if isinstance(raw, (bytes, bytearray)) else raw
    rows = raw[: height * (stride + 1)].reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = (line + prior).astype(np.uint8)
        elif kind in (3, 4):
            cur = np.zeros(stride, np.uint8)
            b_all = prior.astype(np.int32)
            for x in range(0, stride, bpp):
                a = cur[x - bpp: x].astype(np.int32) if x else np.zeros(bpp, np.int32)
                b = b_all[x: x + bpp]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = b_all[x - bpp: x] if x else np.zeros(bpp, np.int32)
                    pred = _paeth(a, b, c)
                cur[x: x + bpp] = (line[x: x + bpp].astype(np.int32) + pred) & 0xFF
        else:
            raise ValueError(f"PNG row {y} has an unknown filter type")
        out[y] = cur
        prior = cur
    return out


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(rows: np.ndarray, bpp: int, kinds: Sequence[int]) -> np.ndarray:
    """(H, stride) uint8 rows -> (H, 1 + stride) filtered rows, row y with
    filter ``kinds[y]``."""
    H, stride = rows.shape
    x = rows.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1, 4: _paeth(a, b, c)}
    out = np.empty((H, stride + 1), np.uint8)
    for y, kind in enumerate(kinds):
        p = pred[int(kind)]
        out[y, 0] = kind
        out[y, 1:] = (x[y] - (p[y] if isinstance(p, np.ndarray) else p)) & 0xFF
    return out


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode_png(pixels: np.ndarray, filters: Optional[Union[int, Sequence[int]]] = None,
               level: int = 6) -> bytes:
    """An (H, W) or (H, W, C) uint8 or uint16 array (C = 1, 2, 3 or 4: grey,
    grey + alpha, RGB, RGBA) as PNG bytes; ``filters`` is one filter type
    for every row or one per row (default 0: unfiltered)."""
    pixels = np.asarray(pixels)
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    H, W, C = pixels.shape
    depth = {np.dtype(np.uint8): 8, np.dtype(np.uint16): 16}.get(pixels.dtype)
    if depth is None or C not in (1, 2, 3, 4):
        raise ValueError(f"cannot write {pixels.dtype} with {C} channels as PNG")
    color = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    samples = pixels.astype(">u2") if depth == 16 else pixels
    rows = np.ascontiguousarray(samples).view(np.uint8).reshape(H, W * C * depth // 8)
    kinds = [0] * H if filters is None else (
        [int(filters)] * H if np.ndim(filters) == 0 else list(filters))
    data = filter_rows(rows, C * depth // 8, kinds).tobytes()
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(data, level)) + _chunk(b"IEND", b""))


def write_png(path, pixels: np.ndarray, filters=None) -> None:
    Path(path).write_bytes(encode_png(pixels, filters))


def decode_ppm(data: bytes) -> np.ndarray:
    """A binary PPM (P6, maximum 255): (H, W, 3) uint8 RGB."""
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos: pos + 1].isspace():
            pos += 1
        if data[pos: pos + 1] == b"#":
            while pos < len(data) and data[pos: pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos: pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError("PPM header is truncated")
        fields.append(data[start:pos])
    if fields[0] != b"P6":
        raise ValueError(f"PPM type {fields[0]!r} is not supported (binary P6 only)")
    W, H, maxval = (int(v) for v in fields[1:])
    if maxval != 255:
        raise ValueError(f"PPM maximum {maxval} is not supported (255 only)")
    pos += 1  # the single whitespace byte after the maximum
    body = np.frombuffer(data, np.uint8, count=H * W * 3, offset=pos)
    return body.reshape(H, W, 3)


def encode_ppm(pixels: np.ndarray) -> bytes:
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8 or pixels.ndim != 3 or pixels.shape[2] != 3:
        raise ValueError(f"PPM takes (H, W, 3) uint8, got {pixels.dtype} {pixels.shape}")
    H, W, _ = pixels.shape
    return f"P6\n{W} {H}\n255\n".encode() + np.ascontiguousarray(pixels).tobytes()


def write_ppm(path, pixels: np.ndarray) -> None:
    Path(path).write_bytes(encode_ppm(pixels))


def imread(path, anydepth: bool = False) -> np.ndarray:
    """(H, W, 3) RGB of a PNG or P6 PPM file, as ``cv2.imread`` gives it
    (flipped to RGB): ``IMREAD_COLOR`` (uint8) by default,
    ``IMREAD_ANYDEPTH | IMREAD_COLOR`` (16-bit kept) with ``anydepth``."""
    data = Path(path).read_bytes()
    if data[:8] == SIGNATURE:
        img = decode_png(data)
    elif data[:1] == b"P" and data[1:2].isdigit():
        img = decode_ppm(data)
    else:
        raise ValueError(f"{path}: neither PNG nor binary PPM")
    if img.shape[2] in (2, 4):
        img = img[..., :-1]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    if img.dtype == np.uint16 and not anydepth:
        img = (img >> 8).astype(np.uint8)
    return np.ascontiguousarray(img)


__all__ = ["decode_png", "decode_ppm", "encode_png", "encode_ppm", "filter_rows", "imread",
           "unfilter_plain", "write_png", "write_ppm"]
