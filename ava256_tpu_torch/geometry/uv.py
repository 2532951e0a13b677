# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""UV-space barycentric maps (host side, numpy + scipy): the port's own copy
of ``ava256_tpu.geometry.uv``, with the same ``.npz`` cache key and layout.

Builds, for every texel of a UV texture, the index of the closest UV triangle
and the barycentric coordinates of the closest point on it. These maps drive
geometry-image rasterization (``ops.geomap.generate_geomap``) and primitive
placement.

Capability parity with the reference pipeline (reference: utils.py:256-384),
which uses trimesh + libigl point-mesh queries. Neither is available here, so
we implement the closest-point query directly: a cKDTree over triangle
centroids proposes candidate triangles per texel, an exact vectorized
point-to-triangle projection (Ericson-style, specialized to 2D) picks the
winner. Results are cached on disk — the reference recomputes this at every
startup; we don't.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
from scipy.spatial import cKDTree

from ava256_tpu_torch.geometry.obj import load_obj


def closest_point_barycentrics_2d(
    tri_pts: np.ndarray, points: np.ndarray, k: int = 16, chunk: int = 16384
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Closest point on a 2D triangle soup for each query point.

    Args:
        tri_pts: [F, 3, 2] triangle corner positions.
        points: [M, 2] query points.
        k: number of candidate triangles (by centroid distance) to test exactly.
        chunk: process queries in blocks of this many points. The exact test
            builds ~15 [M, k, 3, 2] float64 temporaries; unchunked at M=1024^2
            that is tens of GB of allocations and the build spends ~90% of its
            time in kernel page-zeroing rather than arithmetic. The chunk size
            keeps every temporary under glibc's 32MB dynamic mmap threshold so
            freed blocks return to the heap and pages are reused, not re-zeroed
            (measured 8x end-to-end on a 1-core host: 6m43s -> 49s).

    Returns:
        (approx [M,2], barys [M,3], face_idx [M])
    """
    tree = cKDTree(tri_pts.mean(axis=1))
    k = min(k, len(tri_pts))
    m = len(points)
    if m > chunk:
        q = np.empty((m, 2), np.float64)
        bar = np.empty((m, 3), np.float64)
        fidx = np.empty((m,), np.int64)
        for s in range(0, m, chunk):
            sl = slice(s, min(s + chunk, m))
            q[sl], bar[sl], fidx[sl] = _closest_chunk(tree, tri_pts, points[sl], k)
        return q, bar, fidx
    return _closest_chunk(tree, tri_pts, points, k)


def _closest_chunk(tree, tri_pts, points, k):
    _, cand = tree.query(points, k=k)
    if k == 1:
        cand = cand[:, None]

    tp = tri_pts[cand]  # [M, k, 3, 2]
    p = points[:, None, :]  # [M, 1, 2]

    a, b, c = tp[:, :, 0], tp[:, :, 1], tp[:, :, 2]
    ab = b - a
    ac = c - a
    ap = p - a

    # Project onto the triangle plane coordinates (2D: plane == space).
    d00 = np.einsum("mki,mki->mk", ab, ab)
    d01 = np.einsum("mki,mki->mk", ab, ac)
    d11 = np.einsum("mki,mki->mk", ac, ac)
    d20 = np.einsum("mki,mki->mk", ap, ab)
    d21 = np.einsum("mki,mki->mk", ap, ac)
    denom = d00 * d11 - d01 * d01
    denom = np.where(np.abs(denom) < 1e-20, 1e-20, denom)
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w

    # Clamp barycentrics to the triangle: project to the nearest edge/vertex
    # when outside. Handle the three edges explicitly (vectorized).
    bar = np.stack([u, v, w], axis=-1)  # [M, k, 3]
    inside = (bar >= 0.0).all(axis=-1)

    def _edge_clamp(p0, p1):
        e = p1 - p0
        t = np.einsum("mki,mki->mk", p - p0, e) / np.maximum(
            np.einsum("mki,mki->mk", e, e), 1e-20
        )
        t = np.clip(t, 0.0, 1.0)
        q = p0 + t[..., None] * e
        d = np.einsum("mki,mki->mk", p - q, p - q)
        return t, q, d

    t_ab, q_ab, d_ab = _edge_clamp(a, b)
    t_bc, q_bc, d_bc = _edge_clamp(b, c)
    t_ca, q_ca, d_ca = _edge_clamp(c, a)

    dists = np.stack([d_ab, d_bc, d_ca], axis=-1)  # [M, k, 3]
    edge_choice = np.argmin(dists, axis=-1)  # [M, k]

    bar_ab = np.stack([1.0 - t_ab, t_ab, np.zeros_like(t_ab)], axis=-1)
    bar_bc = np.stack([np.zeros_like(t_bc), 1.0 - t_bc, t_bc], axis=-1)
    bar_ca = np.stack([t_ca, np.zeros_like(t_ca), 1.0 - t_ca], axis=-1)
    bar_edges = np.stack([bar_ab, bar_bc, bar_ca], axis=2)  # [M, k, 3edges, 3]
    q_edges = np.stack([q_ab, q_bc, q_ca], axis=2)  # [M, k, 3edges, 2]

    mi, ki = np.meshgrid(
        np.arange(bar.shape[0]), np.arange(bar.shape[1]), indexing="ij"
    )
    bar_out = np.where(inside[..., None], bar, bar_edges[mi, ki, edge_choice])
    q_in = a * bar[..., 0:1] + b * bar[..., 1:2] + c * bar[..., 2:3]
    q_out = np.where(inside[..., None], q_in, q_edges[mi, ki, edge_choice])

    d_final = np.einsum("mki,mki->mk", p - q_out, p - q_out)
    best = np.argmin(d_final, axis=1)  # [M]
    m = np.arange(len(points))
    face_idx = cand[m, best]
    return q_out[m, best], bar_out[m, best], face_idx


def make_closest_uv_barys(
    vt: np.ndarray,
    vti: np.ndarray,
    uv_shape: Union[int, Tuple[int, int]],
    flip_uv: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-texel closest-triangle index image and barycentric map.

    Texel centers follow the OpenGL convention: texel [i, j] maps to
    uv = ((j + 0.5) / W, (i + 0.5) / H). Matches the reference contract
    (reference: utils.py:286-349).

    Returns:
        index_img: [H, W] int64 face indices
        bary_img: [H, W, 3] float32 barycentrics
    """
    if isinstance(uv_shape, int):
        uv_shape = (uv_shape, uv_shape)
    vt = np.asarray(vt, dtype=np.float64)
    if flip_uv:
        vt = vt.copy()
        vt[:, 1] = 1.0 - vt[:, 1]

    h, w = uv_shape
    us = (np.arange(w, dtype=np.float64) + 0.5) / w
    vs = (np.arange(h, dtype=np.float64) + 0.5) / h
    uu, vv = np.meshgrid(us, vs)  # [H, W]
    points = np.stack([uu.ravel(), vv.ravel()], axis=-1)  # [H*W, 2]

    tri_pts = vt[vti]  # [F, 3, 2]
    _, barys, face_idx = closest_point_barycentrics_2d(tri_pts, points)

    index_img = face_idx.reshape(h, w).astype(np.int64)
    bary_img = barys.reshape(h, w, 3).astype(np.float32)
    return index_img, bary_img


def _cache_key(objpath: str, resolution: int) -> str:
    with open(objpath, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return f"uvbaridx_{digest}_{resolution}.npz"


def create_uv_baridx(
    objpath: str,
    resolution: int = 1024,
    cache_dir: Optional[str] = None,
) -> Dict[str, np.ndarray]:
    """Build per-texel triangle-index and barycentric maps from an OBJ.

    Returns the same contract the reference factory consumes
    (reference: utils.py:352-384):
        uv_idx: [3, R, R] int vertex indices per texel (3 triangle corners)
        uv_bary: [3, R, R] float32 barycentrics per texel
        uv_coord: [Nt, 2] texcoords; uv_tri: [F, 3]; tri: [F, 3]

    Rows are stored flipped vertically (V axis) exactly like the reference, so
    geometry images render in the same orientation.
    """
    if cache_dir is None:
        cache_dir = os.environ.get(
            "AVA256_CACHE_DIR", os.path.join(os.path.expanduser("~"), ".cache", "ava256_tpu_torch")
        )
    Path(cache_dir).mkdir(parents=True, exist_ok=True)
    cache_file = Path(cache_dir) / _cache_key(objpath, resolution)

    dotobj = load_obj(objpath)
    vt, vi, vti = dotobj["vt"], dotobj["vi"], dotobj["vti"]

    if cache_file.exists():
        z = np.load(cache_file)
        return {
            "uv_idx": z["uv_idx"],
            "uv_bary": z["uv_bary"],
            "uv_coord": vt,
            "uv_tri": vti,
            "tri": vi,
        }

    index_img, bary_img = make_closest_uv_barys(vt, vti, resolution, flip_uv=False)

    idx = np.stack(
        [np.flipud(vi[index_img, k]) for k in range(3)], axis=0
    ).astype(np.int32)
    bar = np.stack(
        [np.flipud(bary_img[:, :, k]) for k in range(3)], axis=0
    ).astype(np.float32)

    # written under a name of this process, then renamed: another process
    # building the same maps (the ranks of a process group) never reads a
    # file that is still being written
    tmp = cache_file.with_name(f"{cache_file.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        np.savez_compressed(f, uv_idx=idx, uv_bary=bar)
    os.replace(tmp, cache_file)
    return {"uv_idx": idx, "uv_bary": bar, "uv_coord": vt, "uv_tri": vti, "tri": vi}
