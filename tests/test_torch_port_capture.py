# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The port's capture-data path against the JAX package's on the CPU.

- ``load_camera_calibration`` / ``camera_params`` and ``parse_ply_vertices``
  (binary little- and big-endian, ASCII, mixed types; the same refusals):
  equal;
- ``decode_png``: equal to Pillow's decode, exactly, on PNGs Pillow writes
  (its adaptive filters), on PNGs whose rows use each of the five filter
  types, and on the port's own writer's; the features it refuses;
- ``native.resize_bilinear_u8``: equal to the JAX package's native resize,
  exactly (the same source built with the same compiler and flags), and
  within one level of its numpy restatement;
- ``SingleCaptureDataset`` / ``MultiCaptureDataset``: every item (images
  exact, other arrays within 1e-6), the normalization stats,
  ``conditioning_tables``, ``get_neutral_conditioning``, ``item_camindex``,
  ``len``, on a copy of the JAX suite's fixture layout (PNGs written by
  Pillow, random head poses) and on ``data.synthetic.write_capture``'s
  output; JPEG and AVIF captures through Pillow; ``train_csv_loader``;
  ``CameraSplit``; ``ShardedLoader`` batches with thread and process pools
  and ``set_position``;
- a capture whose images need a decoder that is missing is refused when the
  dataset is built, not turned into empty items;
- ``cli.train --device cpu`` on ``configs/config-4.yaml`` over a small
  written capture: 2 steps, a resume, one more; then ``cli.eval
  --holdout-cameras 1``, ``cli.render`` and ``cli.generate_id_cond`` on the
  checkpoint.

The JAX package's loader resizes with its native library when that loads
and falls back to Pillow's bicubic resize when it does not. Its library is
built here into a temporary directory with ``ava256_tpu/native/build.py``'s
own command and the JAX side is pointed at it, so every comparison is
against the native resize. The JAX side's process pool would start without
that (its workers import the package afresh), so the port's process-pool
batches are held against the JAX side's thread-pool batches, which are the
same batches in the same order.
"""

import contextlib
import io
import json
import logging
import re
import shutil
import struct
import sys
import zipfile
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from ava256_tpu_torch import native
from ava256_tpu_torch.cli import eval as port_eval
from ava256_tpu_torch.cli import generate_id_cond as port_idc
from ava256_tpu_torch.cli import render as port_render
from ava256_tpu_torch.cli import train as port_train
from ava256_tpu_torch.data import dataset as pd
from ava256_tpu_torch.data.loader import ShardedLoader
from ava256_tpu_torch.data.png import decode_png
from ava256_tpu_torch.data.synthetic import SyntheticDataset, write_capture, write_topology_obj
from ava256_tpu_torch.geometry import camera_params, load_camera_calibration, parse_ply_vertices
from ava256_tpu_torch.ops.cuda_lib import HOST_FLAGS
from ava256_tpu_torch.train import loop
from ava256_tpu_torch.utils import png_bytes

from tests import _torch_port_threads  # noqa: F401
import ava256_tpu.native as jax_native
from ava256_tpu.data import dataset as jd
from ava256_tpu.data.loader import ShardedLoader as JaxShardedLoader
from ava256_tpu.geometry import krt as jkrt
from ava256_tpu.geometry import ply as jply
from ava256_tpu.native import build as jax_native_build

NVERTS = 64
CAMERAS = ["cam001", "cam002", "cam003"]
FRAMES = [1, 2, 3]


@pytest.fixture(scope="module", autouse=True)
def jax_native_resize(tmp_path_factory):
    """The JAX side's native library, built by its own build.py into a
    temporary directory (never into the package, where the native tests
    build theirs) and loaded in place of any other."""
    tmp = tmp_path_factory.mktemp("jax_native")
    shutil.copy(jax_native.__file__.replace("__init__.py", "dataio.cpp"), tmp / "dataio.cpp")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_native_build, "__file__", str(tmp / "build.py"))
        lib = jax_native_build.build()
        mp.setattr(jax_native, "_LIB_PATH", lib)
        mp.setattr(jax_native, "_LIB", None)
        assert jax_native.available() and jax_native._LIB._name == str(lib)
        yield lib
    finally:
        mp.undo()


def test_host_flags_are_the_jax_builds():
    import inspect

    src = inspect.getsource(jax_native_build.build)
    assert '"g++", ' + ", ".join(f'"{f}"' for f in HOST_FLAGS) in src, src


# ---------------------------------------------------------------------------
# fixtures: the JAX suite's capture layout, and write_capture's
# ---------------------------------------------------------------------------


def _pil_bytes(arr, fmt="PNG", **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **kw)
    return buf.getvalue()


def _ply_bytes(verts, fmt="binary_little_endian", props="xyz", dtype="f4"):
    order = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
    names = {"f4": "float", "f8": "double"}
    header = (f"ply\nformat {fmt} 1.0\nelement vertex {len(verts)}\n"
              + "".join(f"property {names[dtype]} {p}\n" for p in props)
              + "element face 0\nproperty list uchar int vertex_indices\nend_header\n").encode()
    if order is None:
        return header + "".join(" ".join(repr(float(v)) for v in row) + "\n"
                                for row in verts).encode()
    return header + np.ascontiguousarray(verts, order + dtype).tobytes()


def _rotation(rng):
    w = rng.randn(3) * 0.3
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    t = np.linalg.norm(w)
    return np.eye(3) + np.sin(t) / t * k + (1 - np.cos(t)) / t**2 * k @ k


def make_capture(root, seed=0, image_fmt="PNG", ext="png", image_hw=(128, 84)):
    """A miniature capture in the release layout, as the JAX suite's fixture
    (tests/test_dataset.py), with per-camera intrinsics and extrinsics and a
    random head pose per frame."""
    rng = np.random.RandomState(seed)
    for sub in ("image", "uv_image", "kinematic_tracking", "head_pose"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    krt = {"KRT": [{
        "cameraId": c,
        "K": [[2000.0 + 10 * i, 0, 0], [0, 2010.0 - 5 * i, 0], [1334 + i, 2048 - i, 1]],
        "T": np.concatenate([_rotation(rng), rng.randn(1, 3) * 100 + [[0, 0, 1000.0]]]).tolist(),
        "distortion": [0, 0, 0, 0],
    } for i, c in enumerate(CAMERAS)]}
    (root / "camera_calibration.json").write_text(json.dumps(krt))
    (root / "frame_list.csv").write_text(
        "seg_id,frame_id\nEXP_neutral_peak,1\n" + "".join(f"EXP_smile,{f}\n" for f in FRAMES[1:]))
    kw = {"quality": 90} if image_fmt in ("JPEG", "AVIF") else {}
    for cam in CAMERAS:
        with zipfile.ZipFile(root / "image" / f"cam{cam}.zip", "w") as z:
            for f in FRAMES:
                img = rng.randint(0, 255, image_hw + (3,), np.uint8)
                img[:, : image_hw[1] // 2] = np.linspace(0, 255, image_hw[1] // 2)[None, :, None]
                z.writestr(f"cam{cam}/{f:06d}.{ext}", _pil_bytes(img, image_fmt, **kw))
    with zipfile.ZipFile(root / "uv_image" / "color.zip", "w") as z:
        for f in FRAMES:
            z.writestr(f"color/{f:06d}.png",
                       _pil_bytes(rng.randint(0, 255, (64, 64, 3), np.uint8)))
    (root / "uv_image" / "color_mean.png").write_bytes(
        _pil_bytes(rng.randint(0, 255, (64, 64, 3), np.uint8)))
    (root / "uv_image" / "color_variance.txt").write_text("625.0")
    verts = rng.randn(NVERTS, 3).astype(np.float32) * 10
    with zipfile.ZipFile(root / "kinematic_tracking" / "registration_vertices.zip", "w") as z:
        for f in FRAMES:
            z.writestr(f"{f:06d}.ply", _ply_bytes(verts + rng.randn(NVERTS, 3)))
    np.save(root / "kinematic_tracking" / "registration_vertices_mean.npy", verts)
    (root / "kinematic_tracking" / "registration_vertices_variance.txt").write_text("4.0")
    with zipfile.ZipFile(root / "head_pose" / "head_pose.zip", "w") as z:
        for f in FRAMES:
            pose = np.concatenate([_rotation(rng), rng.randn(3, 1) * 20], axis=1)
            z.writestr(f"{f:06d}.txt",
                       "\n".join(" ".join(repr(float(v)) for v in row) for row in pose))
    return root


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """name -> (captures, directories, downsample): two captures of the JAX
    suite's layout, and two identities written by write_capture."""
    tmp = tmp_path_factory.mktemp("captures")
    dirs = [str(make_capture(tmp / f"fixture{i}" / "decoder", seed=i)) for i in range(2)]
    caps = [pd.MugsyCapture("20260101", f"000{i}", f"tst00{i}") for i in range(2)]
    ds = SyntheticDataset(nident=2, ncams=3, nframes=2, height=32, width=21, texsize=64,
                          nverts=NVERTS)
    csv = write_capture(tmp / "written", ds, downsample=128, image_hw=(128, 84))
    wcaps, wdirs = pd.train_csv_loader(tmp / "written", csv, 2)
    return {"fixture": (caps, dirs, 32), "written": (wcaps, wdirs, 128)}


def _jcaps(caps):
    return [jd.MugsyCapture(c.mcd, c.mct, c.sid) for c in caps]


def _equal_items(got, ref):
    assert (got is None) == (ref is None)
    if ref is None:
        return
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        g = got[k]
        assert np.asarray(g).dtype == np.asarray(r).dtype, k
        if k == "image":
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# calibration, PLY, PNG, resize
# ---------------------------------------------------------------------------


def test_camera_calibration_matches_jax(tmp_path):
    path = make_capture(tmp_path / "c", seed=3) / "camera_calibration.json"
    got, ref = load_camera_calibration(path), jkrt.load_camera_calibration(path)
    assert list(got) == list(ref) == CAMERAS
    for cam in CAMERAS:
        assert got[cam].keys() == ref[cam].keys()
        for k in ("intrin", "extrin", "dist"):
            np.testing.assert_array_equal(got[cam][k], ref[cam][k])
        for ds in (1, 4, 8):
            a, b = camera_params(got[cam], ds), jkrt.camera_params(ref[cam], ds)
            for k in b:
                assert a[k].dtype == b[k].dtype == np.float32
                np.testing.assert_array_equal(a[k], b[k])


PLY_CASES = {
    "binary_le": dict(fmt="binary_little_endian"),
    "binary_be": dict(fmt="binary_big_endian"),
    "ascii": dict(fmt="ascii"),
    "double": dict(fmt="binary_little_endian", dtype="f8"),
    "four_props": dict(fmt="binary_big_endian", props="xyzw"),
}


@pytest.mark.parametrize("case", sorted(PLY_CASES))
def test_parse_ply_matches_jax(case):
    kw = PLY_CASES[case]
    verts = np.random.RandomState(5).randn(300, len(kw.get("props", "xyz"))) * 50
    data = _ply_bytes(verts, **kw)
    got = parse_ply_vertices(data)
    assert got.dtype == np.float32 and got.shape == verts.shape
    np.testing.assert_array_equal(parse_ply_vertices(io.BytesIO(data)), got)
    if case == "double":
        # the JAX package's native parser copies float64 properties as if they
        # were float32 (its numpy path, which the port keeps, does not)
        np.testing.assert_array_equal(got, verts.astype(np.float32))
        return
    np.testing.assert_array_equal(got, jply.parse_ply_vertices(data))


@pytest.mark.parametrize("data,match", [
    (b"ply\nformat ascii 1.0\nelement vertex 1\nproperty list uchar int i\nend_header\n1 0\n",
     "list properties"),
    (b"ply\nformat ascii 1.0\nelement vertex 1\nproperty float x\n", "no end_header"),
    (b"plx\nformat ascii 1.0\nend_header\n", "missing magic"),
    (b"ply\nformat ascii 1.0\nelement face 2\nend_header\n", "no vertex element"),
])
def test_parse_ply_refuses_as_jax(data, match):
    for parse in (parse_ply_vertices, jply.parse_ply_vertices):
        with pytest.raises(ValueError, match=match):
            parse(data)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png_from_raw(w, h, c, raw):
    """PNG bytes around the filtered rows ``raw`` of an 8-bit image."""
    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(
            ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


def _filtered_png(img, ftypes):
    """A PNG of uint8 [H, W, C] whose row y uses filter type ftypes[y % len]:
    the filters applied here in Python, as the PNG specification defines them."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        ft = ftypes[y % len(ftypes)]
        up = rows[y - 1] if y else np.zeros(w * c, np.int64)
        out = []
        for i in range(w * c):
            a = rows[y, i - c] if i >= c else 0
            ul = up[i - c] if i >= c else 0
            pred = [0, a, up[i], (a + up[i]) // 2, _paeth(a, up[i], ul)][ft]
            out.append((rows[y, i] - pred) % 256)
        raw += bytes([ft] + out)
    return _png_from_raw(w, h, c, raw)


def _test_image(h, w, c, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    smooth = np.stack([(x * 3 + y) % 256, (y * 4) % 256, (x + y) * 2 % 256, 255 - x % 256],
                      -1)[..., :c]
    img = smooth.astype(np.uint8)
    img[h // 2:] = rng.randint(0, 256, (h - h // 2, w, c))
    return img


@pytest.mark.parametrize("mode,c", [("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)])
def test_decode_png_matches_pillow(mode, c):
    img = _test_image(37, 53, c, seed=c)
    pil_img = Image.fromarray(img[..., 0] if c == 1 else img, mode)
    files = {"pillow": _pil_bytes(np.asarray(pil_img)),
             "pillow_optimize": _pil_bytes(np.asarray(pil_img), optimize=True),
             "filters_0_to_4": _filtered_png(img, [1, 0, 2, 3, 4, 3, 1, 4, 2]),
             "first_row_paeth": _filtered_png(img, [4, 3]),
             "first_row_average": _filtered_png(img, [3, 4])}
    if c != 2:
        files["port_writer"] = png_bytes(img)
    for name, data in files.items():
        ref = np.asarray(Image.open(io.BytesIO(data)))
        got = decode_png(data)
        assert got.dtype == np.uint8 and got.shape == (37, 53, c), name
        np.testing.assert_array_equal(got, ref.reshape(got.shape), err_msg=name)
        np.testing.assert_array_equal(got, img, err_msg=name)


def test_decode_png_reads_every_filter_type():
    """Pillow's adaptive filters and the filtered files above between them
    cover every filter type (the test above would miss a wrong one)."""
    img = _test_image(37, 53, 3, seed=3)
    seen = set()
    for data in (_pil_bytes(img), _filtered_png(img, [1, 0, 2, 3, 4])):
        raw = zlib.decompress(data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8])
        seen |= {raw[y * (53 * 3 + 1)] for y in range(37)}
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("what,match", [
    ("palette", "palette"), ("16-bit", "bit depth 16"), ("interlaced", "interlaced"),
    ("crc", "bad CRC"), ("filter", "filter type 7"), ("signature", "signature"),
    ("truncated", "runs past the end"),
])
def test_decode_png_refuses(what, match):
    img = _test_image(8, 9, 3, seed=0)
    data = bytearray(png_bytes(img))
    if what == "palette":  # 8-bit palettes are read; a 4-bit one is refused
        buf = io.BytesIO()
        Image.fromarray(img).convert("P").save(buf, format="PNG", bits=4)
        data = buf.getvalue()
        assert data[24:26] == b"\x04\x03"  # IHDR: bit depth 4, colour type 3
    elif what == "16-bit":
        buf = io.BytesIO()
        Image.fromarray(img[..., 0].astype(np.uint16) * 200).save(buf, format="PNG")
        data = buf.getvalue()
    elif what == "interlaced":
        data[28] = 1  # IHDR's interlace method, then the chunk's CRC again
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    elif what == "crc":
        data[20] ^= 1  # a byte of IHDR's width
    elif what == "filter":
        raw = bytearray(np.concatenate([np.zeros((8, 1), np.uint8), img.reshape(8, 27)], 1)
                        .tobytes())
        raw[3 * 28] = 7  # row 3's filter type
        data = _png_from_raw(9, 8, 3, raw)
    elif what == "signature":
        data[:6] = b"GIF89a"
    else:
        data = data[:-20]
    with pytest.raises(ValueError, match=match):
        decode_png(bytes(data))


@pytest.mark.parametrize("src,dst", [((4096, 2668, 3), (512, 333)), ((128, 84, 3), (32, 20)),
                                     ((61, 47, 4), (83, 29)), ((33, 35, 1), (7, 70))])
def test_resize_matches_jax_native(src, dst):
    img = np.random.RandomState(sum(src)).randint(0, 256, src).astype(np.uint8)
    got = native.resize_bilinear_u8(img, dst)
    ref = jax_native.resize_bilinear_u8(img, dst)
    assert got.shape == dst + (src[2],)
    np.testing.assert_array_equal(got, ref)
    plain = native.resize_bilinear_u8_plain(img, dst)
    assert np.abs(plain.astype(np.int16) - got).max() <= 1


def test_resize_refuses():
    with pytest.raises(ValueError, match="uint8"):
        native.resize_bilinear_u8(np.zeros((4, 4, 3), np.float32), (2, 2))
    with pytest.raises(ValueError, match="output size"):
        native.resize_bilinear_u8(np.zeros((4, 4, 3), np.uint8), (0, 2))


# ---------------------------------------------------------------------------
# the capture datasets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["fixture", "written"])
def test_single_capture_matches_jax(layouts, layout):
    caps, dirs, ds_factor = layouts[layout]
    got = pd.SingleCaptureDataset(caps[0], dirs[0], downsample=ds_factor)
    ref = jd.SingleCaptureDataset(_jcaps(caps)[0], dirs[0], downsample=ds_factor)
    assert len(got) == len(ref) == 3 * (3 if layout == "fixture" else 2)
    assert got.get_img_size() == ref.get_img_size() == (4096 // ds_factor, 2668 // ds_factor)
    assert got.get_allcameras() == ref.get_allcameras() and got.cameras == ref.cameras
    assert got.camera_map == ref.camera_map and got.framelist == ref.framelist
    np.testing.assert_array_equal(got.texmean, ref.texmean)
    assert (got.texstd, got.vertstd) == (ref.texstd, ref.vertstd)
    np.testing.assert_array_equal(got.neut_avgtex, ref.neut_avgtex)
    np.testing.assert_array_equal(got.neut_vert, ref.neut_vert)
    for i in range(len(ref)):
        assert got.item_ids(i) == ref.item_ids(i)
        assert got.item_camindex(i) == ref.item_camindex(i)
        item = got[i]
        assert item is not None
        _equal_items(item, ref[i])


@pytest.mark.parametrize("layout", ["fixture", "written"])
def test_multi_capture_matches_jax(layouts, layout):
    caps, dirs, ds_factor = layouts[layout]
    got = pd.MultiCaptureDataset(caps, dirs, downsample=ds_factor)
    ref = jd.MultiCaptureDataset(_jcaps(caps), dirs, downsample=ds_factor)
    assert len(got) == len(ref) and list(got.cumulative_sizes) == list(ref.cumulative_sizes)
    assert got.get_allcameras() == ref.get_allcameras()
    assert got.get_img_size() == ref.get_img_size()
    np.testing.assert_allclose(got.texmean, ref.texmean, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.vertmean, ref.vertmean, rtol=1e-6, atol=1e-6)
    assert got.texstd == pytest.approx(ref.texstd, rel=1e-6)
    assert got.vertstd == pytest.approx(ref.vertstd, rel=1e-6)
    for i in range(len(ref)):
        assert got.item_camindex(i) == ref.item_camindex(i)
        item = got[i]
        assert item is not None and int(item["idindex"]) == int(ref[i]["idindex"])
        _equal_items(item, ref[i])
    _equal_items(got[-1], ref[-1])
    for ident in range(len(caps)):
        _equal_items(got.get_neutral_conditioning(ident), ref.get_neutral_conditioning(ident))
    tables, jtables = got.conditioning_tables(), ref.conditioning_tables()
    assert tables.keys() == jtables.keys() == {"id"}
    _equal_items(tables["id"], jtables["id"])


def test_written_capture_gives_the_synthetic_cameras(layouts):
    """write_capture's calibration gives the synthetic dataset's cameras back
    at its downsample, and frame f its frame f - 1."""
    caps, dirs, ds_factor = layouts["written"]
    syn = SyntheticDataset(nident=2, ncams=3, nframes=2, height=32, width=21, texsize=64,
                           nverts=NVERTS)
    ds = pd.MultiCaptureDataset(caps, dirs, downsample=ds_factor)
    assert [c.folder_name() for c in caps] == ["20260101--0000--SYN000", "20260101--0001--SYN001"]
    for i in range(len(ds)):
        item = ds[i]
        ident, cam, frame = int(item["idindex"]), int(item["camindex"]), i % 6 // 3
        ref = syn[frame * 6 + cam * 2 + ident]
        for k in ("camrot", "campos", "focal", "princpt"):
            np.testing.assert_allclose(item[k], ref[k], rtol=1e-5, atol=1e-3, err_msg=k)
        verts = item["verts"] * ds.vertstd + ds.vertmean
        np.testing.assert_allclose(verts, syn._verts(ident, frame), rtol=1e-5, atol=1e-3)


def test_train_csv_loader_matches_jax(tmp_path):
    csv = tmp_path / "ids.csv"
    csv.write_text("sid,mcd,mct,extra\nabc123,20260101,0000,x\nshort,row\n"
                   "def456,20260102,1111,y\nghi789,20260103,2222,z\n")
    for nids in (1, 2, 5):
        caps, dirs = pd.train_csv_loader(tmp_path, csv, nids)
        jcaps, jdirs = jd.train_csv_loader(tmp_path, csv, nids)
        assert [(c.mcd, c.mct, c.sid) for c in caps] == [(c.mcd, c.mct, c.sid) for c in jcaps]
        assert dirs == jdirs and len(caps) == min(nids, 3)
    assert dirs[1].endswith("20260102--1111--def456/decoder")


@pytest.mark.parametrize("heldout", [False, True])
def test_camera_split_on_captures_matches_jax(layouts, heldout):
    caps, dirs, ds_factor = layouts["fixture"]
    ds = pd.MultiCaptureDataset(caps, dirs, downsample=ds_factor)
    jds = jd.MultiCaptureDataset(_jcaps(caps), dirs, downsample=ds_factor)
    held = pd.last_n_camindices(ds, 1)
    assert held == jd.last_n_camindices(jds, 1) == [2]
    split, jsplit = pd.CameraSplit(ds, held, heldout), jd.CameraSplit(jds, held, heldout)
    assert split._indices == jsplit._indices and len(split) == (4 if heldout else 8) * 1.5
    for i in range(len(split)):
        item = split[i]
        assert (int(item["camindex"]) in held) == heldout
        _equal_items(item, jsplit[i])
    assert split.get_allcameras() == ds.get_allcameras()


def _batches(loader, epochs=1, position=None):
    if position is not None:
        loader.set_position(position)
    out = [b for _ in range(epochs) for b in loader]
    close = getattr(loader, "close", None)
    if close is not None:
        close()
    return out


def test_loader_batches_match_jax(layouts):
    caps, dirs, ds_factor = layouts["fixture"]
    ds = pd.MultiCaptureDataset(caps, dirs, downsample=ds_factor)
    jds = jd.MultiCaptureDataset(_jcaps(caps), dirs, downsample=ds_factor)
    kw = dict(batch_size=3, num_workers=3, shuffle=True, seed=2)
    ref = _batches(JaxShardedLoader(jds, **kw), epochs=2)
    runs = {"threads": _batches(ShardedLoader(ds, **kw), epochs=2),
            "resumed": _batches(ShardedLoader(ds, **kw), position=4),
            "processes": _batches(ShardedLoader(ds, use_processes=True, **kw), position=7)}
    assert len(ref) == 12  # 18 items, batches of 3, two epochs
    expect = {"threads": ref, "resumed": ref[4:6], "processes": ref[7:12]}
    for name, got in runs.items():
        assert len(got) == len(expect[name]), name
        for g, r in zip(got, expect[name]):
            assert g["image"].shape[0] == 3, name  # no item was None
            _equal_items(g, r)


# ---------------------------------------------------------------------------
# decoders: through Pillow, and refused at construction when missing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt,ext", [("JPEG", "jpg"), ("AVIF", "avif")])
def test_pillow_formats_match_jax(tmp_path, fmt, ext):
    d = str(make_capture(tmp_path / ext / "decoder", seed=4, image_fmt=fmt, ext=ext))
    cap = pd.MugsyCapture("20260101", "0000", "x")
    got = pd.SingleCaptureDataset(cap, d, downsample=32)
    ref = jd.SingleCaptureDataset(_jcaps([cap])[0], d, downsample=32)
    for i in range(len(ref)):
        _equal_items(got[i], ref[i])


@pytest.mark.parametrize("fmt,ext,block,match", [
    ("JPEG", "jpg", "PIL", r"\.jpg images need Pillow"),
    ("AVIF", "avif", "PIL", r"\.avif images need Pillow"),
    ("AVIF", "avif", "avif", "pillow-avif"),
])
def test_missing_decoder_raises_at_construction(tmp_path, monkeypatch, fmt, ext, block, match):
    d = str(make_capture(tmp_path / "decoder", seed=5, image_fmt=fmt, ext=ext))
    if block == "PIL":
        monkeypatch.setitem(sys.modules, "PIL", None)
    else:
        from PIL import features

        monkeypatch.setattr(features, "check_module", lambda name: False)
        monkeypatch.setitem(sys.modules, "pillow_avif", None)
    cap = pd.MugsyCapture("20260101", "0000", "x")
    for build in (lambda: pd.SingleCaptureDataset(cap, d, downsample=32),
                  lambda: pd.MultiCaptureDataset([cap], [d], downsample=32)):
        with pytest.raises(pd.MissingDecoderError, match=match):
            build()


def test_png_capture_needs_no_pillow(layouts, monkeypatch):
    caps, dirs, ds_factor = layouts["written"]
    monkeypatch.setitem(sys.modules, "PIL", None)
    ds = pd.MultiCaptureDataset(caps, dirs, downsample=ds_factor)
    assert all(ds[i] is not None for i in range(len(ds)))


def test_host_library_build_failure_raises(layouts, tmp_path, monkeypatch):
    """No fallback: a host library that does not build raises the compiler's
    output, from the library and from the dataset's construction."""
    from ava256_tpu_torch.ops import cuda_lib

    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'dataio.cpp:1: error: no compiler here'\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    broken = cuda_lib.HostLib("dataio.cpp", lambda lib: None)
    with pytest.raises(RuntimeError, match="no compiler here"):
        broken.lib()
    monkeypatch.setattr(native, "DATAIO_LIB", broken)
    caps, dirs, ds_factor = layouts["written"]
    with pytest.raises(RuntimeError, match="no compiler here"):
        pd.SingleCaptureDataset(caps[0], dirs[0], downsample=ds_factor)


def test_unreadable_member_is_a_none_item_as_in_jax(tmp_path, caplog):
    d = make_capture(tmp_path / "decoder", seed=6)
    with zipfile.ZipFile(d / "head_pose" / "head_pose.zip", "w") as z:  # frame 3 missing
        for f in FRAMES[:2]:
            z.writestr(f"{f:06d}.txt", "1 0 0 0\n0 1 0 0\n0 0 1 0\n")
    cap = pd.MugsyCapture("20260101", "0000", "x")
    got = pd.SingleCaptureDataset(cap, str(d), downsample=32)
    ref = jd.SingleCaptureDataset(_jcaps([cap])[0], str(d), downsample=32)
    with caplog.at_level(logging.WARNING):
        items = [got[i] for i in range(len(got))]
    assert [i for i, x in enumerate(items) if x is None] == [6, 7, 8]
    assert [i for i in range(len(ref)) if ref[i] is None] == [6, 7, 8]
    assert "failed to fetch 3/cam001" in caplog.text


# ---------------------------------------------------------------------------
# the entry points on configs/config-4.yaml over a written capture
# ---------------------------------------------------------------------------

CONFIG4 = "configs/config-4.yaml"
SHRINK4 = ["train.nids=2", "train.batchsize=2", "train.downsample=128", "model.nprims=256",
           "model.primsize=16", "model.raymarch.tile=8", "model.raymarch.max_hit=16",
           "model.raymarch.nbuf=64", "model.raymarch.dt=16.0", "data.holdout_cameras=1"]


class _LogLines(logging.Handler):
    """The root logger's messages while it is attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture(scope="module")
def capture_runs(tmp_path_factory):
    """cli.train on config-4 over 2 written identities (3 cameras, the last
    held out; 1024^2 textures, as the configuration's UV maps), 2 steps and
    a resume to step 3; then the three inference entry points."""
    tmp = tmp_path_factory.mktemp("capture_cli")
    syn = SyntheticDataset(nident=2, ncams=3, nframes=2, height=32, width=21, texsize=1024,
                           nverts=NVERTS)
    csv = write_capture(tmp / "data", syn, downsample=128, image_hw=(128, 84))
    write_topology_obj(tmp / "assets" / "face_topology.obj", nverts=NVERTS)
    opts = [f"train.dataset_dir={tmp / 'data'}", f"train.data_csv={csv}",
            f"assets={tmp / 'assets'}"] + SHRINK4
    seen, res = [], {"tmp": tmp}
    make = loop.make_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def recorded(state, batch, **skw):
            seen.append((batch["idindex"].tolist(), batch["camindex"].tolist()))
            return step(state, batch, **skw)

        return recorded

    mp = pytest.MonkeyPatch()
    log = _LogLines()
    logging.getLogger().addHandler(log)
    try:
        mp.setenv("AVA256_CACHE_DIR", str(tmp / "cache"))
        mp.delenv("AVA256_LPIPS_WEIGHTS", raising=False)
        mp.setattr(loop, "make_train_step", recording)
        argv = ["--config", CONFIG4, "--device", "cpu",
                f"progress.output_path={tmp / 'run'}"] + opts
        first = port_train.main(argv + ["train.maxiter=2"])
        res["first_step"] = first.step
        res["kept"] = [p.detach().clone() for p in first.model.parameters()]
        res["state"] = port_train.main(argv + ["train.maxiter=3"])
        common = ["--config", CONFIG4, "--device", "cpu", "--checkpoint",
                  str(tmp / "run" / "checkpoints")]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            port_eval.main(common + ["--holdout-cameras", "1", "--num-items", "2", "--opts"]
                           + opts)
        res["eval"] = json.loads(out.getvalue().strip().splitlines()[-1])
        res["rendered"] = port_render.main(common + ["--num-frames", "1", "--output",
                                                     str(tmp / "renders"), "--opts"] + opts)
        res["idc"] = port_idc.main(common + ["--output", str(tmp / "idc"), "--opts"] + opts)
    finally:
        logging.getLogger().removeHandler(log)
        mp.undo()
    res["seen"], res["log"] = seen, log.lines
    return res


def test_train_on_captures_resumes_without_held_out_cameras(capture_runs):
    res = capture_runs
    assert res["first_step"] == 2 and res["state"].step == 3
    assert len(res["seen"]) == 3
    for ids, cams in res["seen"]:
        assert len(ids) == 2 and set(cams) <= {0, 1}  # no None item; camera 2 held out
    assert any("Resumed from" in ln and "step 2" in ln for ln in res["log"])
    losses = [float(m.group(1)) for ln in res["log"]
              if (m := re.match(r"Iteration \d+ loss = (\S+),", ln))]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert not any("failed to fetch" in ln for ln in res["log"])
    params = list(res["state"].model.parameters())
    assert all(bool(torch.isfinite(p).all()) for p in params)
    assert not all(torch.equal(p.detach(), q) for p, q in zip(params, res["kept"]))
    # [gt, rec, err] per batch element at the capture's 32 x 20 (4096 // 128, 2668 // 128)
    png = np.asarray(Image.open(res["tmp"] / "run" / "progress_0.png"))
    assert png.shape == (2 * 32, 3 * 20, 3)


def test_inference_entry_points_on_captures(capture_runs):
    res = capture_runs
    ev = res["eval"]
    assert (ev["split"], ev["items"], ev["checkpoint_step"]) == ("heldout_cameras", 2, 3)
    assert all(np.isfinite(ev[k]) for k in ("psnr_db", "ssim", "lpips_rf"))
    assert res["rendered"] == 1
    render = np.asarray(Image.open(res["tmp"] / "renders" / "render_0000.png"))
    assert render.shape == (32, 3 * 20, 3)
    names = ["20260101--0000--SYN000", "20260101--0001--SYN001"]
    assert res["idc"] == names
    assert sorted(p.name for p in (res["tmp"] / "idc").iterdir()) == [n + ".pkl" for n in names]
