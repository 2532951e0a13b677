# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The port's capture demos (``ava256_tpu_torch.demos``) against the
reference's ``demos/`` on the same captures: three identities written by
``data.synthetic.write_capture`` (2 cameras, 2 frames, 128x84 camera PNGs),
the first with a ``keypoints_3d.zip`` (one ``.npy`` member, one text member)
and a ``segmentation_parts.zip`` (two grey label PNGs from
``utils.png_bytes``, one 8-bit palette PNG from Pillow), the second with the
segmentation archive only, the third with neither.

- ``load_keypoints``: equal bitwise for both member kinds, and
  ``FileNotFoundError`` for a frame no member names, as the reference's;
- the segmentation frames: equal bitwise to Pillow's decode
  (``demos/segmentation.py:36-39``), in the same order, grey and palette;
- ``project_mesh``: ``demos/mesh.py:46-52`` on the JAX package's
  ``SingleCaptureDataset`` item, to 1e-6 relative;
- ``walkthrough``: the reference's printed sections found and missing,
  cameras, frames and item fields, line for line, on each capture;
- each entry point writes a PNG that ``decode_png`` reads back at the size
  its panels give (the walkthrough also as ``python -m``);
- ``ava256_tpu_torch/demos/`` imports nothing of ``jax``, ``ava256_tpu``,
  ``demos``, matplotlib or Pillow.
"""

import ast
import contextlib
import io
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from ava256_tpu_torch.data.png import decode_png
from ava256_tpu_torch.data.synthetic import SyntheticDataset, write_capture
from ava256_tpu_torch.demos import draw, keypoints, mesh, segmentation, walkthrough
from ava256_tpu_torch.utils import png_bytes

from tests import _torch_port_threads  # noqa: F401
from ava256_tpu.data.dataset import MugsyCapture as JaxMugsyCapture
from ava256_tpu.data.dataset import SingleCaptureDataset as JaxSingleCaptureDataset

ROOT = Path(__file__).resolve().parent.parent
DOWNSAMPLE = 128  # the written captures' 128x84 images -> the datasets' 32x20
IMAGE_HW = (128, 84)
SEG_HW = (24, 17)


def _palette_png(labels: np.ndarray) -> bytes:
    """An 8-bit palette PNG from Pillow (a full 256-entry palette)."""
    img = Image.fromarray(labels, "P")
    img.putpalette([(7 * i + c * 50) % 256 for i in range(256) for c in range(3)])
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    data = buf.getvalue()
    assert data[24:26] == b"\x08\x03"  # IHDR: bit depth 8, colour type 3
    return data


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """The three written captures' decoder directories."""
    tmp = tmp_path_factory.mktemp("demos")
    syn = SyntheticDataset(nident=3, ncams=2, nframes=2, height=32, width=21, texsize=64)
    write_capture(tmp, syn, downsample=DOWNSAMPLE, image_hw=IMAGE_HW)
    dirs = sorted(p for p in tmp.glob("*/decoder"))
    rng = np.random.RandomState(0)
    (dirs[0] / "keypoints_3d").mkdir()
    with zipfile.ZipFile(dirs[0] / "keypoints_3d" / "keypoints_3d.zip", "w") as z:
        buf = io.BytesIO()
        np.save(buf, rng.randn(27, 3).astype(np.float32))
        z.writestr("keypoints_3d/000001.npy", buf.getvalue())
        z.writestr("keypoints_3d/000002.txt",
                   "\n".join(" ".join(f"{v:.6f}" for v in row) for row in rng.randn(19, 4)))
    for d in dirs[:2]:
        labels = [rng.randint(0, 24, SEG_HW).astype(np.uint8) for _ in range(3)]
        (d / "segmentation_parts").mkdir()
        with zipfile.ZipFile(d / "segmentation_parts" / "segmentation_parts.zip", "w") as z:
            z.writestr("segmentation_parts/", b"")
            z.writestr("segmentation_parts/cam400002/000002.png", _palette_png(labels[0]))
            z.writestr("segmentation_parts/cam400001/000001.png", png_bytes(labels[1]))
            z.writestr("segmentation_parts/cam400001/000002.png", png_bytes(labels[2]))
    return dirs


# ---------------------------------------------------------------------------
# the data each demo takes out of a capture
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frame", [1, 2])
def test_load_keypoints_equals_the_reference(captures, frame):
    from demos.keypoints import load_keypoints as ref_load_keypoints

    got, ref = keypoints.load_keypoints(str(captures[0]), frame), ref_load_keypoints(
        str(captures[0]), frame)
    assert got.dtype == ref.dtype and got.shape == ref.shape == ((27, 3), (19, 4))[frame - 1]
    np.testing.assert_array_equal(got, ref)


def test_load_keypoints_refuses_a_missing_frame(captures):
    from demos.keypoints import load_keypoints as ref_load_keypoints

    for fn in (keypoints.load_keypoints, ref_load_keypoints):
        with pytest.raises(FileNotFoundError, match="frame 3"):
            fn(str(captures[0]), 3)


@pytest.mark.parametrize("frames", [2, 8])
def test_segmentation_frames_equal_pillows(captures, frames):
    """``demos/segmentation.py:36-39``: the sorted members but directories,
    the first ``frames``, each through Pillow."""
    archive = captures[0] / "segmentation_parts" / "segmentation_parts.zip"
    with zipfile.ZipFile(archive) as z:
        names = sorted(n for n in z.namelist() if not n.endswith("/"))[:frames]
        imgs = [np.asarray(Image.open(io.BytesIO(z.read(n)))) for n in names]
    got_names, got = segmentation.load_frames(str(captures[0]), frames)
    assert got_names == names and len(got) == min(frames, 3)
    modes = []
    for n, a, b in zip(names, got, imgs):
        with zipfile.ZipFile(archive) as z:
            modes.append(Image.open(io.BytesIO(z.read(n))).mode)
        assert a.dtype == b.dtype and a.shape == b.shape == SEG_HW, n
        np.testing.assert_array_equal(a, b, err_msg=n)
    assert {"L", "P"} <= set(modes) or frames < 3, modes


def test_project_mesh_equals_the_reference(captures):
    """``demos/mesh.py:46-52`` on the JAX package's item of the same frame
    and camera."""
    d = str(captures[0])
    ds, frame, camera, item = mesh.fetch(d, None, None, DOWNSAMPLE, "demo")
    verts, px, py = mesh.project_mesh(item, ds.vertmean, ds.vertstd)
    jds = JaxSingleCaptureDataset(JaxMugsyCapture("0", "0", "demo"), d, downsample=DOWNSAMPLE)
    assert (jds.cameras[0], jds.framelist[0][1]) == (camera, frame)
    jitem = jds.fetch(frame, camera)
    rverts = jitem["verts"] * jds.vertstd + jds.vertmean
    cam = jitem["camrot"] @ rverts.T + (-jitem["camrot"] @ jitem["campos"]).reshape(3, 1)
    uv = cam[:2] / cam[2:]
    rpx = uv[0] * jitem["focal"][0] + jitem["princpt"][0]
    rpy = uv[1] * jitem["focal"][1] + jitem["princpt"][1]
    for got, ref in ((verts, rverts), (px, rpx), (py, rpy)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    # the mesh lands in the image
    inside = (px >= 0) & (px < ds.width) & (py >= 0) & (py < ds.height)
    assert inside.mean() > 0.5


def _stdout(fn, argv):
    out = io.StringIO()
    old = sys.argv
    sys.argv = ["demo"] + argv
    try:
        with contextlib.redirect_stdout(out):
            fn()
    finally:
        sys.argv = old
    return out.getvalue().splitlines()


@pytest.mark.parametrize("which", [0, 1, 2])
def test_walkthrough_prints_what_the_reference_prints(captures, tmp_path, which):
    """The sections found and missing, the cameras, the frames and the item's
    fields: the reference's lines, on a capture with keypoints and
    segmentation, with segmentation only and with neither."""
    import matplotlib

    matplotlib.use("Agg")
    from demos import walkthrough as ref_walkthrough

    d = captures[which]
    argv = ["--capture-dir", str(d), "--downsample", str(DOWNSAMPLE)]
    ref = _stdout(ref_walkthrough.main, argv + ["--output", str(tmp_path / "ref.png")])
    got = _stdout(lambda: walkthrough.main(argv + ["--output", str(tmp_path / "port.png")]),
                  [])
    keep = ("capture:", "  [", "cameras:", "frames:", "item fields:", "note:")
    assert [ln for ln in got if ln.startswith(keep)] == [ln for ln in ref if ln.startswith(keep)]
    found, missing = walkthrough.sections(d)
    assert found + missing and set(found) | set(missing) == set(ref_walkthrough.SECTIONS)
    assert len(missing) == (0, 1, 2)[which], missing


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def _sheet_hw(widths, cols, height, gap=8):
    rows = -(-len(widths) // cols)
    return rows * height + (rows + 1) * gap, cols * max(widths) + (cols + 1) * gap


def _read_png(path):
    img = decode_png(Path(path).read_bytes())
    assert img.dtype == np.uint8 and img.shape[2] == 3
    return img.shape[:2]


def test_entry_points_write_their_pngs(captures, tmp_path):
    h, w = 4096 // DOWNSAMPLE, 2668 // DOWNSAMPLE  # the dataset's image: 32 x 20
    out = {k: str(tmp_path / f"{k}.png") for k in ("walk", "kp", "mesh", "seg", "seg1", "walk2")}
    d0, d1 = str(captures[0]), str(captures[1])
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        walkthrough.main(["--capture-dir", d0, "--downsample", str(DOWNSAMPLE),
                          "--output", out["walk"]])
        walkthrough.main(["--capture-dir", d1, "--downsample", str(DOWNSAMPLE), "--frame", "2",
                          "--camera", "400002", "--output", out["walk2"]])
        keypoints.main(["--capture-dir", d0, "--frame", "2", "--output", out["kp"]])
        mesh.main(["--capture-dir", d0, "--downsample", str(DOWNSAMPLE), "--output", out["mesh"]])
        segmentation.main(["--capture-dir", d0, "--output", out["seg"]])
        segmentation.main(["--capture-dir", d0, "--frames", "1", "--output", out["seg1"]])
    # image, mesh, texture (64^2, scaled to the image's height), keypoints
    assert _read_png(out["walk"]) == _sheet_hw([w, w, h, h], 4, h)
    # image, mesh, texture, the first segmentation frame (24 x 17 -> 32 x 23)
    assert _read_png(out["walk2"]) == _sheet_hw([w, w, h, round(17 * h / 24)], 4, h)
    assert _read_png(out["kp"]) == (720, 720)
    assert _read_png(out["mesh"]) == _sheet_hw([w, h], 2, h)
    cell = segmentation.CELL
    assert _read_png(out["seg"]) == _sheet_hw([round(17 * cell / 24)] * 3, 3, cell)
    assert _read_png(out["seg1"]) == _sheet_hw([round(17 * cell / 24)], 1, cell)
    lines = printed.getvalue().splitlines()
    assert "panel 1: 3D keypoints, frame 2 (19 points)" in lines
    assert "panel 4: segmentation: 000001" in lines
    assert sum(ln.startswith("wrote ") for ln in lines) == 6


def test_walkthrough_runs_as_a_module(captures, tmp_path):
    out = tmp_path / "walk.png"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-m", "ava256_tpu_torch.demos.walkthrough",
                        "--capture-dir", str(captures[2]), "--downsample", str(DOWNSAMPLE),
                        "--output", str(out)], capture_output=True, text=True, env=env,
                       cwd=tmp_path, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "note: no keypoints_3d or segmentation_parts in this capture" in r.stdout
    h, w = 4096 // DOWNSAMPLE, 2668 // DOWNSAMPLE
    assert _read_png(out) == _sheet_hw([w, w, h, w], 4, h)


def test_label_panel_colours_labels_through_the_table():
    labels = np.arange(40, dtype=np.uint8).reshape(4, 10)
    panel = draw.label_panel(labels)
    np.testing.assert_array_equal(panel[0, :], draw.TAB20[:10])
    np.testing.assert_array_equal(panel[2], panel[0])  # labels 20-29 wrap to 0-9


def test_demos_import_no_reference_or_imaging_package():
    banned = ("jax", "ava256_tpu", "demos", "matplotlib", "PIL")
    files = sorted((ROOT / "ava256_tpu_torch" / "demos").glob("*.py"))
    assert len(files) == 6
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in banned, (f.name, m)
