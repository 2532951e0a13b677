# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""PLY vertex parsing, host side, numpy only: the port's own copy of
``ava256_tpu.geometry.ply``. The header is parsed once and the vertex block
read with one ``np.frombuffer`` (binary little- or big-endian) or one split
(ASCII)."""

from __future__ import annotations

import io
from typing import BinaryIO, Tuple, Union

import numpy as np

_PLY_DTYPES = {
    b"char": "i1",
    b"int8": "i1",
    b"uchar": "u1",
    b"uint8": "u1",
    b"short": "i2",
    b"int16": "i2",
    b"ushort": "u2",
    b"uint16": "u2",
    b"int": "i4",
    b"int32": "i4",
    b"uint": "u4",
    b"uint32": "u4",
    b"float": "f4",
    b"float32": "f4",
    b"double": "f8",
    b"float64": "f8",
}


def _parse_header(data: bytes) -> Tuple[int, list, str, int]:
    """Returns (n_vertices, [(name, dtype_char)], fmt, header_end_offset)."""
    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError("not a valid PLY file (no end_header)")
    header_end = end + len(b"end_header\n")
    lines = data[:end].split(b"\n")
    if not lines or lines[0].strip() != b"ply":
        raise ValueError("not a valid PLY file (missing magic)")

    fmt = "ascii"
    n_vertices = -1
    props: list = []
    in_vertex_element = False
    for line in lines[1:]:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == b"format":
            fmt = parts[1].decode()
        elif parts[0] == b"element":
            in_vertex_element = parts[1] == b"vertex"
            if in_vertex_element:
                n_vertices = int(parts[2])
        elif parts[0] == b"property" and in_vertex_element:
            if parts[1] == b"list":
                raise ValueError("list properties in vertex element are unsupported")
            props.append((parts[2].decode(), _PLY_DTYPES[parts[1]]))
    if n_vertices < 0:
        raise ValueError("PLY file has no vertex element")
    return n_vertices, props, fmt, header_end


def parse_ply_vertices(src: Union[bytes, BinaryIO]) -> np.ndarray:
    """Parse a PLY file and return all vertex properties as [N, P] float32.

    For the ava-256 registration meshes P == 3 (x, y, z). The vertex element
    must be the first element in the file (true for those assets).
    """
    data = bytes(src if isinstance(src, (bytes, bytearray)) else src.read())
    n, props, fmt, off = _parse_header(data)

    if fmt == "ascii":
        text = data[off:].decode()
        flat = np.array(text.split(), dtype=np.float64)
        ncol = len(props)
        flat = flat[: n * ncol]
        return flat.reshape(n, ncol).astype(np.float32)

    byteorder = "<" if fmt == "binary_little_endian" else ">"
    dtype = np.dtype([(name, byteorder + ch) for name, ch in props])
    rec = np.frombuffer(data, dtype=dtype, count=n, offset=off)
    out = np.empty((n, len(props)), dtype=np.float32)
    for i, (name, _) in enumerate(props):
        out[:, i] = rec[name]
    return out


def parse_ply_vertices_from_bytesio(b: io.BytesIO) -> np.ndarray:
    return parse_ply_vertices(b.getvalue())
