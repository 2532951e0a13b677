# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The registration mesh of a capture: projected into a camera image, and as
a 3D scatter (the port of ``demos/mesh.py``).

    python -m ava256_tpu_torch.demos.mesh --capture-dir /data/.../decoder --frame 1 --camera 401168
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Tuple

import numpy as np

from ava256_tpu_torch.data.dataset import MugsyCapture, SingleCaptureDataset
from ava256_tpu_torch.demos import draw
from ava256_tpu_torch.utils import write_png


def project_mesh(item: Dict[str, Any], vertmean: np.ndarray,
                 vertstd: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A dataset item's vertices, denormalized (head-relative), and their
    pixel coordinates in the item's camera: (verts [V, 3], px [V], py [V])."""
    verts = item["verts"] * vertstd + vertmean
    cam = item["camrot"] @ verts.T + (-item["camrot"] @ item["campos"]).reshape(3, 1)
    uv = cam[:2] / cam[2:]
    px = uv[0] * item["focal"][0] + item["princpt"][0]
    py = uv[1] * item["focal"][1] + item["princpt"][1]
    return verts, px, py


def fetch(capture_dir: str, frame, camera, downsample: int, name: str):
    """The capture's dataset, and the item of (``frame``, ``camera``): the
    first of each when None, as the reference demos pick them."""
    ds = SingleCaptureDataset(MugsyCapture("0", "0", name), capture_dir, downsample=downsample)
    camera = camera or ds.cameras[0]
    frame = str(frame) if frame is not None else ds.framelist[0][1]
    item = ds.fetch(frame, camera)
    if item is None:
        raise SystemExit(f"failed to load frame {frame} camera {camera}")
    return ds, frame, camera, item


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--capture-dir", required=True)
    p.add_argument("--frame", type=int, default=None, help="frame id (default: first)")
    p.add_argument("--camera", default=None, help="camera id (default: first)")
    p.add_argument("--downsample", type=int, default=8)
    p.add_argument("--output", default="mesh_demo.png")
    args = p.parse_args(argv)

    ds, frame, camera, item = fetch(args.capture_dir, args.frame, args.camera,
                                    args.downsample, "demo")
    verts, px, py = project_mesh(item, ds.vertmean, ds.vertstd)
    overlay = draw.splat(draw.image_panel(item["image"]), px, py, draw.LIME)
    h = overlay.shape[0]
    draw.titled([f"frame {frame} cam {camera}", "registration mesh"])
    write_png(args.output, draw.sheet([overlay, draw.points3d_panel(verts, size=h, radius=0)],
                                      2, h))
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
