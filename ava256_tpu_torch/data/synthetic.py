# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Synthetic capture data, numpy only: the port's own copy of
``ava256_tpu.data.synthetic.SyntheticDataset`` (deterministic random
subjects: a per-identity textured ellipsoid pulsing with the frame index,
ray-traced from look-at cameras ~1.1 m away, volradius 256), the synthetic
flagship-sized topology used where no face topology asset is needed, a
topology ``.obj`` over the dataset's own vertices for the entry points'
``assets=`` directory, the dataset written as captures in the ava-256
release's on-disk layout (``write_capture``), and a small raymarch scene for
the kernel tests.
"""

from __future__ import annotations

import json
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ava256_tpu_torch.data.dataset import none_collate  # noqa: F401  (re-exported)
from ava256_tpu_torch.utils import png_bytes

BASE_AXES = np.array([90.0, 120.0, 100.0], np.float32)
LIGHT = np.array([0.40824829, 0.40824829, 0.81649658], np.float32)  # normalized


def _ellipsoid_verts(rng: np.random.RandomState, nverts: int) -> np.ndarray:
    """Unit directions -> head-sized ellipsoid (world units; volradius=256)."""
    pts = rng.randn(nverts, 3).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    return pts * BASE_AXES


def _lookat_camera(rng: np.ndarray, radius: float) -> Dict[str, np.ndarray]:
    # Random position in the front hemisphere, looking at the origin.
    theta = rng.uniform(-0.9, 0.9)  # azimuth
    phi = rng.uniform(-0.5, 0.5)  # elevation
    pos = radius * np.array(
        [np.sin(theta) * np.cos(phi), np.sin(phi), np.cos(theta) * np.cos(phi)],
        np.float32,
    )
    z = -pos / np.linalg.norm(pos)  # camera looks along +z toward origin
    up = np.array([0.0, 1.0, 0.0], np.float32)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    # World-to-camera rows
    rot = np.stack([x, y, z], axis=0).astype(np.float32)
    return {"campos": pos, "camrot": rot}


def _smooth_texture(rng: np.ndarray, texsize: int, ncoarse: int = 12) -> np.ndarray:
    """[texsize, texsize, 3] in [0.15, 0.85]: bilinear-upsampled coarse noise
    (low-frequency, so reconstruction is learnable rather than memorizing
    per-texel noise)."""
    coarse = rng.rand(ncoarse, ncoarse, 3).astype(np.float32)
    t = np.linspace(0.0, ncoarse - 1.0, texsize, dtype=np.float32)
    i0 = np.clip(np.floor(t).astype(np.int64), 0, ncoarse - 2)
    f = (t - i0)[:, None]
    rows = coarse[i0] * (1 - f[..., None]) + coarse[i0 + 1] * f[..., None]
    cols = rows[:, i0] * (1 - f[None, :, 0, None]) + rows[:, i0 + 1] * f[None, :, 0, None]
    return 0.15 + 0.7 * cols


class SyntheticDataset:
    """Deterministic synthetic multi-identity dataset (multi-view-consistent)."""

    def __init__(
        self,
        nident: int = 2,
        ncams: int = 4,
        nframes: int = 8,
        height: int = 128,
        width: int = 128,
        texsize: int = 1024,
        nverts: int = 7306,
        base_verts: Optional[np.ndarray] = None,
        seed: int = 0,
    ):
        self.nident = nident
        self.ncams = ncams
        self.nframes = nframes
        self.height, self.width = height, width
        self.texsize = texsize
        self.seed = seed

        rng = np.random.RandomState(seed)
        if base_verts is None:
            base_verts = _ellipsoid_verts(rng, nverts)
        self.base_verts = base_verts.astype(np.float32)
        self.nverts = self.base_verts.shape[0]
        self._dirs = self.base_verts / np.maximum(
            np.linalg.norm(self.base_verts / BASE_AXES, axis=1, keepdims=True), 1e-8
        ) / BASE_AXES  # unit-sphere directions consistent with base_verts

        self.cameras = [_lookat_camera(rng, radius=1100.0) for _ in range(ncams)]
        self.identities = list(range(nident))

        # Per-identity axis scales (the identity's "shape") and textures
        self.id_axes = [
            BASE_AXES * (1.0 + 0.12 * rng.randn(3).astype(np.float32))
            for _ in range(nident)
        ]
        self.id_phases = [rng.uniform(0, 2 * np.pi) for _ in range(nident)]
        self.id_textures = [_smooth_texture(rng, texsize) for _ in range(nident)]

        # Long-lens look-at framing: the head fills most of the image like
        # the real capture rig's crops.
        self._focal = float(width) * 5.0

        self.vertmean = self.base_verts
        self.vertstd = 10.0
        self.texmean = np.full((texsize, texsize, 3), 0.5, np.float32)
        self.texstd = 0.25

        # Normalized per-identity conditioning is identical for every item of
        # an identity: precompute once (the 1024^2 normalizations otherwise
        # dominate per-item fetch cost ~10x over the actual render).
        self._norm_tex = [
            ((t - 0.5) / self.texstd).astype(np.float32) for t in self.id_textures
        ]
        self._norm_neut_verts = [
            ((self._verts(i, frame=None) - self.vertmean) / self.vertstd).astype(
                np.float32
            )
            for i in range(nident)
        ]
        px, py = np.meshgrid(
            np.arange(width, dtype=np.float32), np.arange(height, dtype=np.float32)
        )
        self._pixelcoords = np.stack([px, py], axis=-1)

    # ---- analytic scene ----

    def _frame_axes(self, ident: int, frame: int) -> np.ndarray:
        """Ellipsoid axes for (identity, frame): a smooth 3-dof pulsation —
        the synthetic 'expression'."""
        ph = self.id_phases[ident] + 2.0 * np.pi * frame / max(self.nframes, 1)
        mod = 1.0 + 0.06 * np.sin(ph + np.array([0.0, 2.094395, 4.18879], np.float32))
        return (self.id_axes[ident] * mod).astype(np.float32)

    def _verts(self, ident: int, frame: Optional[int]) -> np.ndarray:
        axes = (
            np.asarray(self.id_axes[ident])
            if frame is None
            else self._frame_axes(ident, frame)
        )
        return (self._dirs * axes).astype(np.float32)

    def _render(self, ident: int, cam: int, frame: int) -> np.ndarray:
        """Ray-trace the identity's deformed ellipsoid from camera ``cam``:
        [H, W, 3] float32 in roughly [0, 255]."""
        axes = self._frame_axes(ident, frame)
        c = self.cameras[cam]
        fx = fy = self._focal
        px, py = self.width / 2.0, self.height / 2.0
        u, v = np.meshgrid(
            np.arange(self.width, dtype=np.float32),
            np.arange(self.height, dtype=np.float32),
        )
        d_cam = np.stack(
            [(u - px) / fx, (v - py) / fy, np.ones_like(u)], axis=-1
        )  # [H, W, 3]
        d = d_cam @ c["camrot"]  # camrot rows are camera axes: R^T d_cam
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = c["campos"]

        # Ray-ellipsoid: ||(o + t d) / axes||^2 = 1
        os_, ds_ = o / axes, d / axes
        a = np.sum(ds_ * ds_, axis=-1)
        b = 2.0 * np.sum(ds_ * os_, axis=-1)
        cc = float(np.sum(os_ * os_)) - 1.0
        disc = b * b - 4.0 * a * cc
        hit = disc > 0.0
        t = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2.0 * a)
        hit &= t > 0.0
        p = o + t[..., None] * d  # [H, W, 3] hit points
        n = p / (axes * axes)
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
        shade = 0.35 + 0.65 * np.maximum(n @ LIGHT, 0.0)

        # Texture by spherical coordinates of the (undeformed) direction
        dirs = p / axes
        tu = (np.arctan2(dirs[..., 0], dirs[..., 2]) / (2 * np.pi) + 0.5) * (
            self.texsize - 1
        )
        tv = (np.clip(dirs[..., 1], -1.0, 1.0) * 0.5 + 0.5) * (self.texsize - 1)
        tex = self.id_textures[ident][
            tv.astype(np.int64), tu.astype(np.int64)
        ]  # [H, W, 3]
        img = 255.0 * tex * shade[..., None]
        return np.where(hit[..., None], img, 0.0).astype(np.float32)

    # ---- dataset interface ----

    def get_allcameras(self) -> List[int]:
        return list(range(self.ncams))

    def get_neutral_conditioning(self, ident: int) -> Dict[str, np.ndarray]:
        return {
            "neut_avgtex": self._norm_tex[ident],
            "neut_verts": self._norm_neut_verts[ident],
        }

    def get_img_size(self):
        return (self.height, self.width)

    def conditioning_tables(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Device-cacheable batch fields (see data/cond_cache.py): the
        per-frame average texture equals the neutral identity texture here,
        so every conditioning input is a per-identity or per-camera constant
        and the per-step payload reduces to image + verts + indices."""
        id_tex = np.stack(self._norm_tex)
        return {
            "id": {
                "avgtex": id_tex,
                "neut_avgtex": id_tex,
                "neut_verts": np.stack(self._norm_neut_verts),
            },
            "cam": {
                "camrot": np.stack([c["camrot"] for c in self.cameras]),
                "campos": np.stack([c["campos"] for c in self.cameras]),
                "focal": np.tile(np.full((1, 2), self._focal, np.float32), (self.ncams, 1)),
                "princpt": np.tile(np.array([[self.width / 2, self.height / 2]], np.float32),
                                   (self.ncams, 1)),
            },
            "const": {
                "modelmatrix": np.eye(4, dtype=np.float32),
                "pixelcoords": self._pixelcoords,
            },
        }

    def __len__(self) -> int:
        return self.nident * self.ncams * self.nframes

    def item_camindex(self, idx: int) -> int:
        """Camera index of item ``idx`` without fetching it (split support)."""
        return (idx // self.nident) % self.ncams

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        ident = idx % self.nident
        cam = (idx // self.nident) % self.ncams
        frame = idx // (self.nident * self.ncams)

        focal = np.full((2,), self._focal, np.float32)
        princpt = np.array([self.width / 2, self.height / 2], np.float32)

        verts = self._verts(ident, frame)
        image = self._render(ident, cam, frame)

        # The per-frame average texture is the shading-free identity texture
        # (the real capture's tracked-mesh unwrap also removes most view
        # effects), so avgtex == neut_avgtex here — both precomputed views.
        return dict(
            camrot=self.cameras[cam]["camrot"],
            campos=self.cameras[cam]["campos"],
            focal=focal,
            princpt=princpt,
            modelmatrix=np.eye(4, dtype=np.float32),
            avgtex=self._norm_tex[ident],
            verts=((verts - self.vertmean) / self.vertstd).astype(np.float32),
            neut_avgtex=self._norm_tex[ident],
            neut_verts=self._norm_neut_verts[ident],
            pixelcoords=self._pixelcoords,
            idindex=np.int32(ident),
            camindex=np.int32(cam),
            image=image,
            validinput=True,
        )


def synthetic_uvdata(resolution: int, nverts: int = 7306, nfaces: int = 14000,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """A random topology with the flagship's vertex count, in the layout of
    ``geometry.create_uv_baridx``: uv_idx / uv_bary [3, M, M], uv_coord
    [V, 2], uv_tri / tri [F, 3]."""
    rng = np.random.RandomState(seed)
    return {
        "uv_idx": rng.randint(0, nverts, size=(3, resolution, resolution)).astype(np.int32),
        "uv_bary": np.full((3, resolution, resolution), 1.0 / 3.0, np.float32),
        "uv_coord": rng.rand(nverts, 2).astype(np.float32),
        "uv_tri": rng.randint(0, nverts, size=(nfaces, 3)).astype(np.int32),
        "tri": rng.randint(0, nverts, size=(nfaces, 3)).astype(np.int32),
    }


def write_topology_obj(path, nverts: int = 7306, seed: int = 0) -> Path:
    """Write a topology ``.obj`` over the vertices ``SyntheticDataset(nverts=,
    seed=)`` draws when it is given no ``base_verts`` (so the vertex count
    matches the dataset's): UVs from a spherical map of the vertices
    (azimuth, height), faces from a Delaunay triangulation of the UVs, one
    texcoord per vertex. Returns the path. The entry points read
    ``{assets}/face_topology.obj``: write it there."""
    from scipy.spatial import Delaunay

    verts = _ellipsoid_verts(np.random.RandomState(seed), nverts)
    d = verts / BASE_AXES
    uv = np.stack([np.arctan2(d[:, 0], d[:, 2]) / (2 * np.pi) + 0.5,
                   np.clip(d[:, 1], -1.0, 1.0) * 0.5 + 0.5], axis=-1)
    faces = Delaunay(uv).simplices + 1  # obj indices are 1-based
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"vt {u:.6f} {v:.6f}" for u, v in uv]
    lines += [f"f {a}/{a} {b}/{b} {c}/{c}" for a, b, c in faces]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")
    return path


CAPTURE_HW = (4096, 2668)  # the release's camera images, height x width


def _ply_bytes(verts: np.ndarray) -> bytes:
    header = (b"ply\nformat binary_little_endian 1.0\n"
              + f"element vertex {len(verts)}\n".encode()
              + b"property float x\nproperty float y\nproperty float z\nend_header\n")
    return header + np.ascontiguousarray(verts, "<f4").tobytes()


def write_capture(root, dataset: SyntheticDataset, downsample: int = 8,
                  image_hw: Tuple[int, int] = CAPTURE_HW) -> Path:
    """Write every identity of ``dataset`` as one capture in the ava-256
    release's on-disk layout (see ``data.dataset``) under
    ``root/{mcd}--{mct}--{sid}/decoder``, and the release's CSV of ids
    (``mcd,mct,sid``) as ``root/ids.csv``; returns the CSV's path.

    Per capture: ``camera_calibration.json`` with the dataset's cameras, the
    intrinsics scaled by ``downsample`` (so that a capture dataset at that
    downsample gives the model the dataset's rays back; every capture has the
    same camera ids); ``frame_list.csv`` with frame 1 in
    ``EXP_neutral_peak``; ``image/cam{ID}.zip`` with each render enlarged by
    nearest neighbour to cover ``image_hw`` and cropped to it (the release's
    4096 x 2668 by default), as PNG (zlib level 1, filter type 0) stored
    uncompressed in the zip; ``registration_vertices.zip``
    with one binary PLY per frame, their mean (``.npy``) and variance;
    ``uv_image/color.zip`` with the identity's texture per frame, and
    ``color_mean.png`` / ``color_variance.txt``; ``head_pose.zip`` with
    identity poses. Frame f (from 1) is the dataset's frame f - 1."""
    root = Path(root)
    h, w = image_hw
    scale = max(-(-h // dataset.height), -(-w // dataset.width))
    frames = range(1, dataset.nframes + 1)
    cams = [str(400001 + c) for c in range(dataset.ncams)]
    intrin = np.array([[dataset._focal, 0.0, dataset.width / 2],
                       [0.0, dataset._focal, dataset.height / 2],
                       [0.0, 0.0, 1.0]]) * np.array([[downsample], [downsample], [1.0]])
    krt = []
    for cam, c in zip(cams, dataset.cameras):
        rot = c["camrot"].astype(np.float64)
        extrin = np.concatenate([rot, -rot @ c["campos"].astype(np.float64)[:, None]], axis=1)
        krt.append({"cameraId": cam, "K": intrin.T.tolist(), "T": extrin.T.tolist(),
                    "distortion": [0.0, 0.0, 0.0, 0.0, 0.0]})
    pose = "\n".join(" ".join(str(v) for v in row) for row in np.eye(4)[:3]) + "\n"
    rows = ["mcd,mct,sid"]
    for ident in range(dataset.nident):
        mcd, mct, sid = "20260101", f"{ident:04d}", f"SYN{ident:03d}"
        rows.append(f"{mcd},{mct},{sid}")
        d = root / f"{mcd}--{mct}--{sid}" / "decoder"
        for sub in ("image", "kinematic_tracking", "uv_image", "head_pose"):
            (d / sub).mkdir(parents=True, exist_ok=True)
        (d / "camera_calibration.json").write_text(json.dumps({"KRT": krt}))
        (d / "frame_list.csv").write_text("seg_id,frame_id\n" + "".join(
            f"{'EXP_neutral_peak' if f == 1 else 'EXP_free_face'},{f}\n" for f in frames))
        for cam_idx, cam in enumerate(cams):
            with zipfile.ZipFile(d / "image" / f"cam{cam}.zip", "w", zipfile.ZIP_STORED) as z:
                for f in frames:
                    img = np.clip(np.rint(dataset._render(ident, cam_idx, f - 1)), 0, 255)
                    big = img.astype(np.uint8).repeat(scale, 0).repeat(scale, 1)[:h, :w]
                    z.writestr(f"cam{cam}/{f:06d}.png", png_bytes(big, 1))
        verts = np.stack([dataset._verts(ident, f - 1) for f in frames])
        mean = verts.mean(axis=0).astype(np.float32)
        with zipfile.ZipFile(d / "kinematic_tracking" / "registration_vertices.zip", "w") as z:
            for f, v in zip(frames, verts):
                z.writestr(f"{f:06d}.ply", _ply_bytes(v))
        np.save(d / "kinematic_tracking" / "registration_vertices_mean.npy", mean)
        (d / "kinematic_tracking" / "registration_vertices_variance.txt").write_text(
            f"{float(np.var(verts - mean)):.6f}\n")
        tex = np.clip(np.rint(dataset.id_textures[ident] * 255.0), 0, 255).astype(np.uint8)
        tex_png = png_bytes(tex, 1)
        with zipfile.ZipFile(d / "uv_image" / "color.zip", "w", zipfile.ZIP_STORED) as z:
            for f in frames:
                z.writestr(f"color/{f:06d}.png", tex_png)
        (d / "uv_image" / "color_mean.png").write_bytes(tex_png)
        (d / "uv_image" / "color_variance.txt").write_text(f"{float(np.var(tex)):.6f}\n")
        with zipfile.ZipFile(d / "head_pose" / "head_pose.zip", "w") as z:
            for f in frames:
                z.writestr(f"{f:06d}.txt", pose)
    csv = root / "ids.csv"
    csv.write_text("\n".join(rows) + "\n")
    return csv


def raymarch_scene(n: int = 2, h: int = 33, w: int = 33, k3: int = 3, bs: int = 8,
                   warp: bool = False, seed: int = 0) -> Dict[str, Any]:
    """A small raymarch scene, numpy only, after the JAX suite's gradcheck
    scene: coherent camera rays, a jittered k3^3 grid of randomly rotated
    primitives and softplus templates (alpha biased low so rays are partly
    transparent), optionally near-identity warp fields. Rotations are given
    as Rodrigues vectors (``primrvec``); callers turn them into matrices."""
    rng = np.random.RandomState(seed)
    K = k3**3
    focal = np.full((n, 2), w * 4.0, np.float32)
    princpt = np.array([[w * 0.5, h * 0.5]] * n, np.float32)
    px, py = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    pix = np.tile(np.stack([px, py], -1)[None], (n, 1, 1, 1))
    rd = np.concatenate([(pix - princpt[:, None, None]) / focal[:, None, None],
                         np.ones((n, h, w, 1), np.float32)], axis=-1)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = np.tile(np.array([0.0, 0.0, -4.0], np.float32), (n, h, w, 1))
    max_len = 6.0
    tminmax = (max_len * np.arange(2, dtype=np.float32)[None, None, None, :]
               + rng.rand(n, h, w, 2).astype(np.float32))
    g = np.linspace(-1, 1, k3, dtype=np.float32)
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    grid = np.stack([gz, gy, gx], -1).reshape(1, K, 3)
    primpos = np.tile((grid + 0.1 * rng.randn(1, K, 3)).astype(np.float32), (n, 1, 1)) * 0.3
    template = rng.randn(n, K, bs, bs, bs, 4).astype(np.float32)
    template[..., 3] -= 3.5
    out = dict(
        raypos=ro, raydir=rd.astype(np.float32), stepsize=max_len / 15.386928,
        tminmax=tminmax, primpos=primpos.astype(np.float32),
        primrvec=rng.randn(n, K, 3).astype(np.float32),
        primscale=np.ones((n, K, 3), np.float32),
        template=np.log1p(np.exp(template * 1.5)).astype(np.float32), warp=None)
    if warp:
        wg = np.stack(np.meshgrid(*([np.linspace(-1, 1, bs, dtype=np.float32)] * 3),
                                  indexing="ij")[::-1], axis=-1)
        out["warp"] = (0.01 * rng.randn(n, K, bs, bs, bs, 3) + wg).astype(np.float32)
    return out
