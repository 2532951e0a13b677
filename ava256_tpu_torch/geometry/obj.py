# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Wavefront OBJ loading (host side, numpy only): the port's own copy of
``ava256_tpu.geometry.obj``."""

from __future__ import annotations

from typing import Dict, List, TextIO, Union

import numpy as np

ObjectType = Dict[str, Union[List[np.ndarray], np.ndarray]]


def load_obj(path: Union[str, TextIO], return_vn: bool = False) -> ObjectType:
    """Load a wavefront OBJ file.

    Args:
        path: filename or open text handle.
        return_vn: include vertex normals in the output.

    Returns:
        dict with:
            v:   [Nv, 3] float32 vertex positions
            vt:  [Nt, 2] float32 texture coordinates
            vi:  [F, 3] int32 vertex indices per face (list of arrays if the
                 file mixes face arities)
            vti: [F, 3] int32 texcoord indices per face
            vn:  [Nn, 3] float32 normals (only if return_vn)
    """
    if isinstance(path, str):
        with open(path, "r") as f:
            lines = f.readlines()
    else:
        lines = path.readlines()

    v: List[List[float]] = []
    vt: List[List[float]] = []
    vn: List[List[float]] = []
    vindices: List[List[int]] = []
    vtindices: List[List[int]] = []

    for line in lines:
        if line == "":
            break
        tag = line[:2]
        if tag == "v ":
            v.append([float(x) for x in line.split()[1:]])
        elif tag == "vt":
            vt.append([float(x) for x in line.split()[1:]])
        elif tag == "vn":
            vn.append([float(x) for x in line.split()[1:]])
        elif tag == "f ":
            fields = line.split()[1:]
            vindices.append([int(entry.split("/")[0]) - 1 for entry in fields])
            if "/" in line:
                vtindices.append([int(entry.split("/")[1]) - 1 for entry in fields])

    if len(vt) == 0:
        if len(vtindices) != 0:
            raise ValueError("OBJ has texcoord indices but no texcoords")
        vt = [[0.5, 0.5]]
        vtindices = [[0, 0, 0]] * len(vindices)

    arity0 = len(vindices[0]) if vindices else 3
    mixed = any(len(f) != arity0 for f in vindices)
    if mixed:
        vi: Union[List[np.ndarray], np.ndarray] = [np.asarray(f, dtype=np.int32) for f in vindices]
        vti: Union[List[np.ndarray], np.ndarray] = [np.asarray(f, dtype=np.int32) for f in vtindices]
    else:
        vi = np.asarray(vindices, dtype=np.int32)
        vti = np.asarray(vtindices, dtype=np.int32)

    out: ObjectType = {
        "v": np.asarray(v, dtype=np.float32),
        "vt": np.asarray(vt, dtype=np.float32),
        "vi": vi,
        "vti": vti,
    }
    if return_vn:
        vn_arr = np.asarray(vn, dtype=np.float32)
        if len(vn_arr) == 0:
            raise ValueError("requested normals but OBJ has none")
        out["vn"] = vn_arr
    return out
