"""The reference's own UV maps of a topology ``.obj``: for every texel of an
M x M texture (texel centres at ((j + 0.5) / M, (i + 0.5) / M)), the
triangle of the UV layout closest to it, its three vertex indices and the
clamped barycentrics of the closest point (16 candidate triangles by
centroid distance, tested exactly), rows flipped vertically; and each
vertex's UV sampling coordinate in [-1, 1] (the first face that names it).
Built with numpy and scipy and cached on disk beside the benchmark's other
caches, keyed by the file's content and the resolution."""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Dict

import numpy as np
from scipy.spatial import cKDTree

from benchmark.reference.model import vertex_uv_coords


def load_obj(path) -> Dict[str, np.ndarray]:
    v, vt, vi, vti = [], [], [], []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v":
            v.append([float(x) for x in parts[1:4]])
        elif parts[0] == "vt":
            vt.append([float(x) for x in parts[1:3]])
        elif parts[0] == "f":
            vi.append([int(p.split("/")[0]) - 1 for p in parts[1:]])
            vti.append([int(p.split("/")[1]) - 1 for p in parts[1:]])
    return {"v": np.asarray(v, np.float32), "vt": np.asarray(vt, np.float32),
            "vi": np.asarray(vi, np.int32), "vti": np.asarray(vti, np.int32)}


def _closest(tree, tri, p, k):
    _, cand = tree.query(p, k=k)
    tp = tri[cand]  # [M, k, 3, 2]
    p = p[:, None, :]
    a, b, c = tp[:, :, 0], tp[:, :, 1], tp[:, :, 2]
    ab, ac, ap = b - a, c - a, p - a

    def dot(x, y):
        return np.einsum("mki,mki->mk", x, y)

    d00, d01, d11, d20, d21 = dot(ab, ab), dot(ab, ac), dot(ac, ac), dot(ap, ab), dot(ap, ac)
    den = d00 * d11 - d01 * d01
    den = np.where(np.abs(den) < 1e-20, 1e-20, den)
    bv = (d11 * d20 - d01 * d21) / den
    bw = (d00 * d21 - d01 * d20) / den
    bar = np.stack([1.0 - bv - bw, bv, bw], axis=-1)
    inside = (bar >= 0.0).all(axis=-1)

    def edge(p0, p1):
        e = p1 - p0
        t = np.clip(dot(p - p0, e) / np.maximum(dot(e, e), 1e-20), 0.0, 1.0)
        q = p0 + t[..., None] * e
        return t, q, dot(p - q, p - q)

    (t0, q0, e0), (t1, q1, e1), (t2, q2, e2) = edge(a, b), edge(b, c), edge(c, a)
    choice = np.argmin(np.stack([e0, e1, e2], axis=-1), axis=-1)
    z = np.zeros_like(t0)
    bar_e = np.stack([np.stack([1.0 - t0, t0, z], -1), np.stack([z, 1.0 - t1, t1], -1),
                      np.stack([t2, z, 1.0 - t2], -1)], axis=2)
    q_e = np.stack([q0, q1, q2], axis=2)
    mi, ki = np.meshgrid(np.arange(bar.shape[0]), np.arange(bar.shape[1]), indexing="ij")
    bar_out = np.where(inside[..., None], bar, bar_e[mi, ki, choice])
    q_in = a * bar[..., 0:1] + b * bar[..., 1:2] + c * bar[..., 2:3]
    q_out = np.where(inside[..., None], q_in, q_e[mi, ki, choice])
    best = np.argmin(dot(p - q_out, p - q_out), axis=1)
    m = np.arange(len(best))
    return bar_out[m, best], cand[m, best]


def build(objpath, res: int) -> Dict[str, np.ndarray]:
    obj = load_obj(objpath)
    vt = obj["vt"].astype(np.float64)
    tri = vt[obj["vti"]]
    s = (np.arange(res, dtype=np.float64) + 0.5) / res
    uu, vv = np.meshgrid(s, s)
    pts = np.stack([uu.ravel(), vv.ravel()], axis=-1)
    tree = cKDTree(tri.mean(axis=1))
    k = min(16, len(tri))
    bary = np.empty((len(pts), 3))
    face = np.empty(len(pts), np.int64)
    for lo in range(0, len(pts), 16384):
        sl = slice(lo, lo + 16384)
        bary[sl], face[sl] = _closest(tree, tri, pts[sl], k)
    face, bary = face.reshape(res, res), bary.reshape(res, res, 3).astype(np.float32)
    vi = obj["vi"]
    return {"uv_idx": np.stack([np.flipud(vi[face, j]) for j in range(3)]).astype(np.int64),
            "uv_bary": np.stack([np.flipud(bary[:, :, j]) for j in range(3)]),
            "vert_coords": vertex_uv_coords(obj["vt"], vi, obj["vti"], len(obj["v"]))}


def uv_maps(objpath, res: int, cache_dir) -> Dict[str, np.ndarray]:
    """``build``'s maps, from the cache when it holds them."""
    digest = hashlib.sha256(Path(objpath).read_bytes()).hexdigest()[:16]
    path = Path(cache_dir) / f"reference_uv_{digest}_{res}.npz"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **build(objpath, res))
        os.replace(tmp, path)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
