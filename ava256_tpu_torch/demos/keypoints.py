# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""3D keypoints from a capture's ``keypoints_3d`` archive, drawn as a 3D
scatter (the port of ``demos/keypoints.py``).

    python -m ava256_tpu_torch.demos.keypoints --capture-dir /data/.../decoder --frame 1
"""

from __future__ import annotations

import argparse
import io
import zipfile
from pathlib import Path

import numpy as np

from ava256_tpu_torch.demos import draw
from ava256_tpu_torch.utils import write_png


def load_keypoints(capture_dir: str, frame: int) -> np.ndarray:
    """The keypoints of ``frame``: the first member of
    ``keypoints_3d/keypoints_3d.zip`` whose name holds the zero-padded frame,
    read as ``.npy`` or as text (float32, at least 2-D)."""
    with zipfile.ZipFile(Path(capture_dir) / "keypoints_3d" / "keypoints_3d.zip") as z:
        target = f"{frame:06d}"
        for name in z.namelist():
            if target in name:
                data = z.read(name)
                if name.endswith(".npy"):
                    return np.load(io.BytesIO(data))
                return np.loadtxt(io.BytesIO(data), dtype=np.float32, ndmin=2)
    raise FileNotFoundError(f"no keypoints for frame {frame}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--capture-dir", required=True)
    p.add_argument("--frame", type=int, default=1)
    p.add_argument("--output", default="keypoints_demo.png")
    args = p.parse_args(argv)

    kp = load_keypoints(args.capture_dir, args.frame)
    xyz = kp[:, :3] if kp.shape[1] >= 3 else kp
    draw.titled([f"3D keypoints, frame {args.frame} ({len(xyz)} points)"])
    write_png(args.output, draw.points3d_panel(xyz, size=720))
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
