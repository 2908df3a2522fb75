"""PNG writing and reading for 8-bit RGB images, from the standard library
only (`zlib`, `struct`): the port's frontends need no imaging package.

`encode_rgb` writes filter type 0 (None) on every row and one IDAT chunk;
`decode_rgb` reads back what `encode_rgb` writes (8-bit RGB, no interlace,
filter type 0 rows), for checks of the served images.
"""

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_rgb(arr_u8_hwc):
    """(H, W, 3) uint8 -> the bytes of a PNG file."""
    a = np.asarray(arr_u8_hwc)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"encode_rgb wants an (H, W, 3) uint8 array, got {a.dtype} {a.shape}")
    h, w, _ = a.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # each row: filter byte 0, then RGB
    rows[:, 1:] = a.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit, truecolour, no interlace
    return (SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def decode_rgb(data):
    """The bytes of a PNG that `encode_rgb` wrote -> (H, W, 3) uint8."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(kind + body):
            raise ValueError(f"bad CRC in the {kind!r} chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, colour, _, _, interlace = header
    if (depth, colour, interlace) != (8, 2, 0):
        raise ValueError(f"decode_rgb reads 8-bit RGB without interlace, got {header}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("decode_rgb reads rows of filter type 0 only")
    return rows[:, 1:].reshape(h, w, 3).copy()
