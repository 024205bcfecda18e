"""Readers of the raw file formats of the FT3D and KITTI preprocessing
(port of ``pvraft_tpu/data/preprocess/io_formats.py``):

  * PFM (Portable Float Map): FT3D disparity and disparity change;
  * Middlebury ``.flo``: FT3D optical flow;
  * PNG: FT3D occlusion masks, KITTI disparity (uint16 / 256) and flow
    ((uint16 - 2^15) / 64 with a validity plane).

The PNG decoder is the port's own (``zlib`` and ``struct``): neither
OpenCV nor imageio is installed where the port runs, and PIL reduces
16-bit RGB to 8 bits. It reads non-interlaced gray (colour type 0) and
RGB (colour type 2) images of 8 or 16 bits per sample, through all five
row filters, and refuses anything else. An RGB image comes back in RGB
order, as the JAX package's reader returns it.
"""

from __future__ import annotations

import re
import struct
import zlib
from typing import Tuple

import numpy as np

FLO_MAGIC = 202021.25
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
PNG_CHANNELS = {0: 1, 2: 3}  # colour type -> samples per pixel


def read_pfm(path: str) -> np.ndarray:
    """A PFM image as float32 (H, W) or (H, W, 3), top row first."""
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").strip()
        if header == "PF":
            channels = 3
        elif header == "Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        dims = f.readline().decode("latin-1")
        m = re.match(r"^\s*(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: bad PFM dimensions {dims!r}")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode("latin-1").strip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(f.read(width * height * channels * 4),
                             dtype=endian + "f4")
    img = (data.reshape(height, width, channels) if channels == 3
           else data.reshape(height, width))
    # PFM stores rows bottom-up.
    return np.flipud(img).astype(np.float32).copy()


def read_flo(path: str) -> np.ndarray:
    """A Middlebury .flo optical flow file as (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.frombuffer(f.read(4), np.float32)[0]
        if magic != FLO_MAGIC:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        width = int(np.frombuffer(f.read(4), np.int32)[0])
        height = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(width * height * 2 * 4), np.float32)
    return data.reshape(height, width, 2).copy()


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters: (height, stride) uint8."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, x = rows[y, 0], rows[y, 1:]
        if kind == 0:                                   # None
            line = x.copy()
        elif kind == 1:                                 # Sub
            # Each byte adds the byte bpp to its left: a running sum over
            # the row's pixels, per channel byte, modulo 256.
            line = np.cumsum(x.reshape(-1, bpp), axis=0,
                             dtype=np.uint8).reshape(-1)
        elif kind == 2:                                 # Up
            line = x + prior
        elif kind in (3, 4):                            # Average, Paeth
            cur = bytearray(x.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            line = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = line
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, 3) array, uint8 or uint16."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG chunk")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    width, height, depth, colour, compression, filt, interlace = header
    if colour not in PNG_CHANNELS or depth not in (8, 16):
        raise ValueError(f"PNG colour type {colour} at {depth} bits is not "
                         f"read: gray or RGB at 8 or 16 bits only")
    if compression != 0 or filt != 0:
        raise ValueError(f"PNG compression {compression} / filter method "
                         f"{filt} is not read")
    if interlace != 0:
        raise ValueError("interlaced PNG is not read")
    channels = PNG_CHANNELS[colour]
    bpp = channels * depth // 8
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height,
                       width * bpp, bpp)
    if depth == 16:
        pixels = pixels.view(">u2").astype(np.uint16)
    shape = (height, width) if channels == 1 else (height, width, channels)
    return pixels.reshape(shape)


def read_png16(path: str) -> np.ndarray:
    """A PNG at its own bit depth (8 or 16), RGB in RGB order."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_png(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e


def read_kitti_disparity(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI disparity PNG: uint16 / 256; 0 marks invalid (-1.0)."""
    arr = read_png16(path)
    valid = arr > 0
    disp = arr.astype(np.float32) / 256.0
    disp[~valid] = -1.0
    return disp, valid


def read_kitti_flow(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI optical-flow PNG: channels (u, v, valid); (x - 2^15) / 64."""
    arr = read_png16(path)
    valid = arr[..., -1] == 1
    flow = (arr[..., :-1].astype(np.float32) - 2.0**15) / 64.0
    return flow, valid
