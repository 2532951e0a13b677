# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Capture datasets, dataset views and collation: the port's own copy of
``ava256_tpu.data.dataset``. Items are dicts of numpy arrays (NHWC images),
equal to the JAX package's.

On-disk layout per capture (the ava-256 release's):
    camera_calibration.json
    frame_list.csv                          (seg_id, frame_id)
    image/cam{ID}.zip -> cam{ID}/{frame:06d}.avif
    kinematic_tracking/registration_vertices.zip -> {frame:06d}.ply
    kinematic_tracking/registration_vertices_mean.npy / _variance.txt
    uv_image/color.zip -> color/{frame:06d}.avif
    uv_image/color_mean.png / color_variance.txt
    head_pose/head_pose.zip -> {frame:06d}.txt

Images are probed by extension (``.avif``, ``.png``, ``.jpg``, ``.jpeg``).
PNG is decoded by ``data.png`` and resized by the host data library
(``native.resize_bilinear_u8``); AVIF and JPEG only through Pillow (AVIF:
Pillow 11.2+ built with libavif, or the pillow-avif plugin). A capture whose
images need a decoder that is missing is refused when the dataset is built
(``MissingDecoderError``), as is a host library that does not build. Any
other per-item failure returns None; ``none_collate`` drops None items and
the train loop skips empty batches.
"""

from __future__ import annotations

import bisect
import io
import logging
import math
import zipfile
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ava256_tpu_torch import native
from ava256_tpu_torch.data.png import SIGNATURE as PNG_SIGNATURE
from ava256_tpu_torch.data.png import decode_png
from ava256_tpu_torch.geometry.krt import load_camera_calibration
from ava256_tpu_torch.geometry.ply import parse_ply_vertices
from ava256_tpu_torch.train.profiling import annotate

logger = logging.getLogger("ava256_tpu_torch.data")

_IMAGE_EXTS = (".avif", ".png", ".jpg", ".jpeg")


class MissingDecoderError(ImportError):
    """A capture's images need an imaging package that is not installed."""


def _pillow(ext: str):
    """``PIL.Image``, able to open ``ext`` files, or ``MissingDecoderError``."""
    try:
        from PIL import Image, features
    except ImportError as e:
        raise MissingDecoderError(
            f"{ext} images need Pillow, which is not installed (the port decodes PNG "
            "without it)") from e
    if ext == ".avif":
        try:
            ok = features.check_module("avif")
        except ValueError:  # Pillow before 11.2 knows no AVIF module
            ok = False
        if not ok:
            try:
                import pillow_avif  # noqa: F401  (registers the AVIF plugin)
            except ImportError as e:
                raise MissingDecoderError(
                    ".avif images need pillow-avif (the pillow-avif-plugin package) or "
                    "Pillow 11.2+ built with libavif; neither is installed") from e
    return Image


def _require_decoders(names: Sequence[str]) -> None:
    """Raise ``MissingDecoderError`` if a file named in ``names`` is an image
    that no installed package decodes."""
    for ext in sorted({Path(n).suffix.lower() for n in names} & set(_IMAGE_EXTS) - {".png"}):
        _pillow(ext)


@dataclass(frozen=True)
class MugsyCapture:
    """Unique identifier for a capture: date, time, subject id."""

    mcd: str
    mct: str
    sid: str
    is_relightable: bool = False

    def folder_name(self) -> str:
        return f"{self.mcd}--{self.mct}--{self.sid}"


def _zip_read(zf: zipfile.ZipFile, name_noext: str) -> bytes:
    """Read a member, probing the supported image extensions."""
    names = set(zf.namelist())
    for ext in _IMAGE_EXTS:
        cand = name_noext + ext
        if cand in names:
            return zf.read(cand)
    raise FileNotFoundError(f"{name_noext}[{'/'.join(_IMAGE_EXTS)}] not in archive")


def _decode_image(data: bytes, resize: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Image bytes -> float32 [H, W, 3] (the first three channels; grey
    repeated), resized to ``resize`` = (W, H) when given."""
    if data[:8] == PNG_SIGNATURE:
        arr8 = decode_png(data)
    else:  # AVIF / JPEG
        img = _pillow(".avif" if data[4:12] in (b"ftypavif", b"ftypavis") else ".jpg").open(
            io.BytesIO(data))
        arr8 = np.asarray(img)
        if arr8.ndim == 2:
            arr8 = arr8[..., None]
    if resize is not None:
        arr8 = native.resize_bilinear_u8(arr8, (resize[1], resize[0]))
    arr = arr8.astype(np.float32)
    if arr.shape[2] == 1:
        arr = arr.repeat(3, axis=-1)
    return arr[..., :3]  # HWC


def read_frame_list(path: Path) -> List[Tuple[str, str]]:
    """frame_list.csv -> [(seg_id, frame_id), ...]."""
    rows: List[Tuple[str, str]] = []
    with open(path, "r") as f:
        header = f.readline().strip().split(",")
        si, fi = header.index("seg_id"), header.index("frame_id")
        for line in f:
            parts = line.strip().split(",")
            if len(parts) > max(si, fi):
                rows.append((parts[si], parts[fi]))
    return rows


def get_framelist_neuttex_and_neutvert(
    dataset_dir: Path,
) -> Tuple[List[Tuple[str, str]], np.ndarray, np.ndarray]:
    """Load the frame list and the first available neutral texture+vertices
    (from the EXP_neutral_peak segment)."""
    dataset_dir = Path(dataset_dir)
    framelist = read_frame_list(dataset_dir / "frame_list.csv")

    neut_frames = sorted(f for seg, f in framelist if seg == "EXP_neutral_peak")
    with zipfile.ZipFile(dataset_dir / "uv_image" / "color.zip") as texzip, zipfile.ZipFile(
        dataset_dir / "kinematic_tracking" / "registration_vertices.zip"
    ) as vertzip:
        vert_names = set(vertzip.namelist())
        for frame in neut_frames:
            plyname = f"{int(frame):06d}.ply"
            if plyname not in vert_names:
                continue
            try:
                verts = parse_ply_vertices(vertzip.read(plyname))
                tex = _decode_image(_zip_read(texzip, f"color/{int(frame):06d}"))
                return framelist, tex, verts
            except MissingDecoderError:
                raise
            except Exception as e:  # noqa: BLE001
                logger.warning("neutral frame %s unreadable: %s", frame, e)
    raise ValueError("Unable to find any neutral vertices or average textures")


class SingleCaptureDataset:
    """Assets for one capture. Items are dicts of numpy arrays (NHWC images)."""

    def __init__(
        self,
        capture: MugsyCapture,
        directory: str,
        downsample: int = 4,
        cameras_specified: Optional[Sequence[str]] = None,
    ):
        self.capture = capture
        self.dir = Path(directory)
        self.downsample = downsample
        self.height, self.width = 4096 // downsample, 2668 // downsample
        self.identities = [capture]
        if not self.dir.exists():
            raise FileNotFoundError(f"Dataset directory {self.dir} does not exist")

        krt_dicts = load_camera_calibration(self.dir / "camera_calibration.json")
        self.cameras = list(krt_dicts.keys())
        if cameras_specified is not None:
            self.cameras = [c for c in cameras_specified if c in self.cameras]
            if not self.cameras:
                raise ValueError(f"no cameras left for {capture}")

        # what fetch needs from the environment, checked here so that it
        # never turns into empty batches: the image decoders of this
        # capture's formats (from its first camera archive and its textures)
        # and the host data library
        cam_zips = (self.dir / "image" / f"cam{c}.zip" for c in self.cameras)
        for path in (next((z for z in cam_zips if z.exists()), None),
                     self.dir / "uv_image" / "color.zip"):
            if path is not None:
                with zipfile.ZipFile(path) as zf:
                    _require_decoders(zf.namelist())
        native.DATAIO_LIB.lib()

        self.campos, self.camrot, self.focal, self.princpt = {}, {}, {}, {}
        for cam, krt in krt_dicts.items():
            ext, intr = krt["extrin"], krt["intrin"]
            self.campos[cam] = (-ext[:3, :3].T @ ext[:3, 3]).astype(np.float32)
            self.camrot[cam] = ext[:3, :3].astype(np.float32)
            self.focal[cam] = (np.diag(intr[:2, :2]) / downsample).astype(np.float32)
            self.princpt[cam] = (intr[:2, 2] / downsample).astype(np.float32)
        self.camera_map = {c: i for i, c in enumerate(self.cameras)}

        # Normalization stats (HWC texture mean)
        self.texmean = _decode_image((self.dir / "uv_image" / "color_mean.png").read_bytes())
        self.texstd = float(
            np.genfromtxt(self.dir / "uv_image" / "color_variance.txt") ** 0.5
        )
        self.vertmean = np.load(
            self.dir / "kinematic_tracking" / "registration_vertices_mean.npy"
        )
        self.vertstd = float(
            np.genfromtxt(
                self.dir / "kinematic_tracking" / "registration_vertices_variance.txt"
            )
            ** 0.5
        )

        self.framelist, self.neut_avgtex, self.neut_vert = get_framelist_neuttex_and_neutvert(
            self.dir
        )
        # zip handles, opened at first use in each process
        self._zips: Dict[str, zipfile.ZipFile] = {}

    def __getstate__(self):
        # open zip handles are not picklable (and must not be shared across
        # worker processes: duplicated fds race on the file offset); they
        # re-open lazily in each worker
        state = self.__dict__.copy()
        state["_zips"] = {}
        return state

    def _zip(self, rel: str) -> zipfile.ZipFile:
        zf = self._zips.get(rel)
        if zf is None:  # two loader threads may get here at once: one handle is kept
            zf = zipfile.ZipFile(self.dir / rel)
            kept = self._zips.setdefault(rel, zf)
            if kept is not zf:
                zf.close()
            zf = kept
        return zf

    def fetch(self, frame_id: str, camera_id: str) -> Optional[Dict[str, Any]]:
        try:
            fid = int(frame_id)
            img = _decode_image(
                _zip_read(self._zip(f"image/cam{camera_id}.zip"), f"cam{camera_id}/{fid:06d}"),
                resize=(self.width, self.height),
            )
            verts = parse_ply_vertices(
                self._zip("kinematic_tracking/registration_vertices.zip").read(
                    f"{fid:06d}.ply"
                )
            )
            avgtex = _decode_image(
                _zip_read(self._zip("uv_image/color.zip"), f"color/{fid:06d}")
            )
            headpose = np.loadtxt(
                io.BytesIO(self._zip("head_pose/head_pose.zip").read(f"{fid:06d}.txt")),
                dtype=np.float32,
            )
        except MissingDecoderError:
            raise
        except Exception as e:  # noqa: BLE001
            logger.warning("failed to fetch %s/%s: %s", frame_id, camera_id, e)
            return None

        px, py = np.meshgrid(
            np.arange(self.width, dtype=np.float32),
            np.arange(self.height, dtype=np.float32),
        )
        pixelcoords = np.stack([px, py], axis=-1)

        hr = headpose[:3, :3]
        ht = headpose[:3, 3]
        return dict(
            # head-pose-relative camera
            camrot=(hr.T @ self.camrot[camera_id].T).T.astype(np.float32),
            campos=(hr.T @ (self.campos[camera_id] - ht)).astype(np.float32),
            focal=self.focal[camera_id],
            princpt=self.princpt[camera_id],
            modelmatrix=np.eye(4, dtype=np.float32),
            avgtex=((avgtex - self.texmean) / self.texstd).astype(np.float32),
            verts=((verts - self.vertmean) / self.vertstd).astype(np.float32),
            neut_avgtex=((self.neut_avgtex - self.texmean) / self.texstd).astype(np.float32),
            neut_verts=((self.neut_vert - self.vertmean) / self.vertstd).astype(np.float32),
            pixelcoords=pixelcoords,
            idindex=np.int32(0),
            camindex=np.int32(self.camera_map[camera_id]),
            image=img,
            headpose=headpose,
            validinput=True,
        )

    def item_ids(self, idx: int) -> Tuple[str, str, str]:
        seg, frame = self.framelist[idx // len(self.cameras)]
        camera = self.cameras[idx % len(self.cameras)]
        return seg, frame, camera

    def item_camindex(self, idx: int) -> int:
        """Camera index of item ``idx`` without fetching it (split support)."""
        return idx % len(self.cameras)

    def __getitem__(self, idx: int) -> Optional[Dict[str, Any]]:
        _, frame, camera = self.item_ids(idx)
        return self.fetch(frame, camera)

    def __len__(self) -> int:
        return len(self.cameras) * len(self.framelist)

    def get_allcameras(self) -> Set[str]:
        return set(self.cameras)

    def get_img_size(self) -> Tuple[int, int]:
        return (self.height, self.width)


class MultiCaptureDataset:
    """Concatenation over captures with cross-identity normalization stats
    pushed into every child. Camera indices are per capture (each child's
    ``camera_map``), the camera count is the union's."""

    def __init__(
        self,
        captures: List[MugsyCapture],
        directories: List[str],
        downsample: int = 4,
        cameras_specified: Optional[Sequence[str]] = None,
    ):
        self.captures = captures
        self.dirs = directories
        self.downsample = downsample
        self.height, self.width = 4096 // downsample, 2668 // downsample
        self.identities = captures

        self.single_capture_datasets = {
            cap: SingleCaptureDataset(cap, d, downsample, cameras_specified)
            for cap, d in zip(captures, directories)
        }
        self.cumulative_sizes = np.cumsum(
            [len(x) for x in self.single_capture_datasets.values()]
        )
        self.total_len = int(self.cumulative_sizes[-1])

        self.texmean, self.texstd = self._texture_norm_stats()
        self.vertmean, self.vertstd = self._vert_norm_stats()
        for ds in self.single_capture_datasets.values():
            ds.texmean, ds.texstd = self.texmean, self.texstd
            ds.vertmean, ds.vertstd = self.vertmean, self.vertstd

    def _texture_norm_stats(self) -> Tuple[np.ndarray, float]:
        dsets = list(self.single_capture_datasets.values())
        n = len(dsets)
        texmean = sum(d.texmean for d in dsets) / n
        if n == 1:
            texvar = float(np.mean((texmean - texmean.mean(axis=0, keepdims=True)) ** 2))
        else:
            texvar = sum(float(np.sum((d.texmean - texmean) ** 2)) for d in dsets)
            texvar /= texmean.size * n
        return texmean, math.sqrt(texvar)

    def _vert_norm_stats(self) -> Tuple[np.ndarray, float]:
        dsets = list(self.single_capture_datasets.values())
        n = len(dsets)
        vertmean = sum(d.vertmean for d in dsets) / n
        vertvar = sum(float(np.sum((d.vertmean - vertmean) ** 2)) for d in dsets)
        vertvar /= vertmean.size * n
        vertvar += sum(d.vertstd**2 for d in dsets) / n
        return vertmean, math.sqrt(vertvar)

    def get_neutral_conditioning(self, ident: int) -> Dict[str, np.ndarray]:
        """Normalized neutral texture+vertices for identity ``ident``: the
        conditioning used for cross-identity driving."""
        ds = self.single_capture_datasets[self.captures[ident]]
        return {
            "neut_avgtex": ((ds.neut_avgtex - self.texmean) / self.texstd).astype(
                np.float32
            ),
            "neut_verts": ((ds.neut_vert - self.vertmean) / self.vertstd).astype(
                np.float32
            ),
        }

    def conditioning_tables(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Device-cacheable per-identity neutral conditioning (see
        data/cond_cache.py). Only the neutral fields are static on real
        captures: avgtex, verts and cameras vary per frame and per capture."""
        conds = [self.get_neutral_conditioning(i) for i in range(len(self.captures))]
        return {
            "id": {
                "neut_avgtex": np.stack([c["neut_avgtex"] for c in conds]),
                "neut_verts": np.stack([c["neut_verts"] for c in conds]),
            }
        }

    def __getitem__(self, idx: int) -> Optional[Dict[str, Any]]:
        if idx < 0:
            if -idx > len(self):
                raise ValueError("index out of range")
            idx = len(self) + idx
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        sample_idx = idx if ds_idx == 0 else idx - self.cumulative_sizes[ds_idx - 1]
        sample = self.single_capture_datasets[self.captures[ds_idx]][int(sample_idx)]
        if sample is not None:
            sample["idindex"] = np.int32(ds_idx)
        return sample

    def __len__(self) -> int:
        return self.total_len

    def item_camindex(self, idx: int) -> int:
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        sample_idx = idx if ds_idx == 0 else idx - self.cumulative_sizes[ds_idx - 1]
        return self.single_capture_datasets[self.captures[ds_idx]].item_camindex(
            int(sample_idx)
        )

    def get_allcameras(self) -> Set[str]:
        out: Set[str] = set()
        for ds in self.single_capture_datasets.values():
            out |= ds.get_allcameras()
        return out

    def get_img_size(self) -> Tuple[int, int]:
        return (self.height, self.width)


def none_collate(items: List[Optional[Dict[str, Any]]]) -> Optional[Dict[str, Any]]:
    """Stack dict items into a batch, dropping failed (None) samples."""
    with annotate("ava:collate"):
        items = [x for x in items if x is not None]
        if not items:
            return None
        out: Dict[str, Any] = {}
        for k in items[0]:
            vals = [it[k] for it in items]
            if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]) or isinstance(
                vals[0], (np.integer, np.floating, int, float, bool)
            ):
                out[k] = np.stack([np.asarray(v) for v in vals])
            else:
                out[k] = vals
    return out


class CameraSplit:
    """Camera-level train / held-out split as a view over any dataset that
    has ``item_camindex``.

    The base dataset keeps ALL cameras (so ``get_allcameras``/``camindex``
    and the per-camera colorcal/background tables stay globally indexed);
    the view only restricts which items iterate. ``heldout=False`` yields
    the training split (holdout cameras excluded), ``heldout=True`` the
    evaluation split (holdout cameras only).
    """

    def __init__(self, dataset, holdout_camindices, heldout: bool):
        self.dataset = dataset
        hold = {int(c) for c in holdout_camindices}
        self._indices = [
            i for i in range(len(dataset))
            if (dataset.item_camindex(i) in hold) == heldout
        ]
        if not self._indices:
            raise ValueError(
                f"camera split (heldout={heldout}, cams={sorted(hold)}) is empty"
            )

    def __getattr__(self, name):
        # never forward dunder lookups, and bail before __dict__ is populated,
        # so the split pickles cleanly (as LeanView in data/cond_cache.py)
        if name.startswith("__") or "dataset" not in self.__dict__:
            raise AttributeError(name)
        return getattr(self.dataset, name)

    def __getitem__(self, idx: int):
        return self.dataset[self._indices[int(idx)]]

    def __len__(self) -> int:
        return len(self._indices)


def last_n_camindices(dataset, n: int) -> List[int]:
    """The deterministic holdout set: the last ``n`` camera indices."""
    ncams = len(dataset.get_allcameras())
    if not 0 < n < ncams:
        raise ValueError(f"holdout_cameras={n} must be in (0, {ncams})")
    return list(range(ncams - n, ncams))


def train_csv_loader(
    base_dir: Path, csv_path: Path, nids: int
) -> Tuple[List[MugsyCapture], List[str]]:
    """The first ``nids`` captures of the release's CSV of ids (columns
    mcd, mct, sid) and their ``{base_dir}/{mcd}--{mct}--{sid}/decoder``
    directories."""
    captures: List[MugsyCapture] = []
    dirs: List[str] = []
    with open(csv_path, "r") as f:
        header = f.readline().strip().split(",")
        idx = {name: i for i, name in enumerate(header)}
        for line in f:
            if len(captures) >= nids:
                break
            parts = line.strip().split(",")
            if len(parts) < 3:
                continue
            cap = MugsyCapture(
                mcd=parts[idx["mcd"]], mct=parts[idx["mct"]], sid=parts[idx["sid"]]
            )
            captures.append(cap)
            dirs.append(f"{base_dir}/{cap.folder_name()}/decoder")
    return captures, dirs
