# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""PNG decoding without an imaging package: the chunks are read here, the
image data inflated with ``zlib`` and its rows unfiltered by the host data
library (``native.png_unfilter``). 8-bit grey, grey + alpha, RGB, RGBA and
palette (its index plane, as Pillow's ``np.asarray`` gives it), non-interlaced;
anything else raises ``ValueError`` naming the feature.
(``utils.write_png`` writes what this reads.)"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ava256_tpu_torch import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> channels (palette: its index)
_COLOUR_NAMES = {3: "palette (colour type 3)"}


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's bytes -> uint8 [H, W, C] (C = 1 grey or a palette's
    indices, 2 grey + alpha, 3 RGB, 4 RGBA). Every chunk's CRC is checked."""
    data = memoryview(data)
    if bytes(data[:8]) != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos, header, idat = 8, None, []
    while True:
        if pos + 12 > len(data):
            raise ValueError("PNG file ends before its IEND chunk")
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"PNG chunk {tag!r} runs past the end of the file")
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(body, zlib.crc32(tag)) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {tag!r}: bad CRC")
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, ctype, compression, filt, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not supported (grey, grey + alpha, "
                         "RGB, RGBA and palette are)")
    if depth != 8:
        raise ValueError(f"PNG {_COLOUR_NAMES.get(ctype, 'image')} of bit depth {depth} is "
                         "not supported (8 is)")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    if compression or filt:
        raise ValueError(f"PNG compression method {compression} / filter method {filt} "
                         "is not supported (0 / 0 are)")
    c = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    return native.png_unfilter(raw, h, w * c, c).reshape(h, w, c)
