# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""A guided walk through one capture (the port of ``demos/walkthrough.py``):
the release layout's sections found and missing, one (frame, camera) item
through ``SingleCaptureDataset``, and a contact sheet of four panels: the
camera image, the registration mesh projected into it, the unwrapped
texture, and the 3D keypoints or a segmentation frame when the capture ships
them (a blank panel and a note when it ships neither).

    python -m ava256_tpu_torch.demos.walkthrough --capture-dir /data/.../decoder
"""

from __future__ import annotations

import argparse
import zipfile
from pathlib import Path
from typing import List, Tuple

from ava256_tpu_torch.demos import draw
from ava256_tpu_torch.demos.keypoints import load_keypoints
from ava256_tpu_torch.demos.mesh import fetch, project_mesh
from ava256_tpu_torch.demos.segmentation import as_pillow, label_or_image
from ava256_tpu_torch.data.png import decode_png
from ava256_tpu_torch.utils import write_png

SECTIONS = (
    "camera_calibration.json", "frame_list.csv", "image", "uv_image",
    "kinematic_tracking", "head_pose", "keypoints_3d", "segmentation_parts",
)


def sections(root) -> Tuple[List[str], List[str]]:
    """The release layout's sections that ``root`` has, and those it lacks."""
    found = [s for s in SECTIONS if (Path(root) / s).exists()]
    return found, [s for s in SECTIONS if s not in found]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--capture-dir", required=True)
    p.add_argument("--frame", type=int, default=None)
    p.add_argument("--camera", default=None)
    p.add_argument("--downsample", type=int, default=8)
    p.add_argument("--output", default="walkthrough.png")
    args = p.parse_args(argv)

    root = Path(args.capture_dir)
    print(f"capture: {root}")
    found, _ = sections(root)
    for s in SECTIONS:
        print(f"  [{'found  ' if s in found else 'MISSING'}] {s}")

    ds, frame, camera, item = fetch(str(root), args.frame, args.camera, args.downsample,
                                    "walkthrough")
    print(f"cameras: {len(ds.cameras)} {ds.cameras[:6]}{'...' if len(ds.cameras) > 6 else ''}")
    print(f"frames:  {len(ds.framelist)} (first: {ds.framelist[0]})")
    print(f"item fields: {sorted(item.keys())}")

    # 1. the camera image; 2. the registration mesh projected into it
    img = draw.image_panel(item["image"])
    h, w = img.shape[:2]
    verts, px, py = project_mesh(item, ds.vertmean, ds.vertstd)
    panels = [img, draw.splat(img, px, py, draw.LIME)]
    titles = [f"image — frame {frame} cam {camera}", f"registration mesh ({len(verts)} verts)"]

    # 3. the unwrapped texture
    if "avgtex" in item:
        panels.append(draw.texture_panel(item["avgtex"]))
        titles.append("unwrapped uv texture")
    else:
        panels.append(draw.blank_panel(h, w))
        titles.append("uv texture: not in item")

    # 4. keypoints or segmentation, whichever the capture ships
    seg = root / "segmentation_parts" / "segmentation_parts.zip"
    if (root / "keypoints_3d").exists():
        kp = load_keypoints(str(root), int(frame))
        panels.append(draw.points3d_panel(kp, size=h))
        titles.append(f"3D keypoints ({len(kp)})")
    elif seg.exists():
        with zipfile.ZipFile(seg) as z:
            name = sorted(n for n in z.namelist() if not n.endswith("/"))[0]
            panels.append(label_or_image(as_pillow(decode_png(z.read(name)))))
        titles.append(f"segmentation: {Path(name).stem}")
    else:
        panels.append(draw.blank_panel(h, w))
        titles.append("keypoints/segmentation: not shipped")
        print("note: no keypoints_3d or segmentation_parts in this capture")

    draw.titled(titles)
    write_png(args.output, draw.sheet(panels, 4, h))
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
