# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Segmentation parts as a grid of frames (the port of
``demos/segmentation.py``), decoded by ``data.png`` instead of Pillow.

    python -m ava256_tpu_torch.demos.segmentation --capture-dir /data/.../decoder --frames 8
"""

from __future__ import annotations

import argparse
import zipfile
from pathlib import Path
from typing import List, Tuple

import numpy as np

from ava256_tpu_torch.data.png import decode_png
from ava256_tpu_torch.demos import draw
from ava256_tpu_torch.utils import write_png

CELL = 360  # each frame's height in the grid


def as_pillow(img: np.ndarray) -> np.ndarray:
    """``decode_png``'s [H, W, C] as Pillow's ``np.asarray`` gives it: [H, W]
    for one channel (grey, or a palette's indices)."""
    return img[..., 0] if img.shape[2] == 1 else img


def load_frames(capture_dir: str, frames: int) -> Tuple[List[str], List[np.ndarray]]:
    """The first ``frames`` members of ``segmentation_parts.zip`` by name
    (directories skipped), and each one's decoded image."""
    archive = Path(capture_dir) / "segmentation_parts" / "segmentation_parts.zip"
    with zipfile.ZipFile(archive) as z:
        names = sorted(n for n in z.namelist() if not n.endswith("/"))[:frames]
        return names, [as_pillow(decode_png(z.read(n))) for n in names]


def label_or_image(img: np.ndarray) -> np.ndarray:
    """A label map through the 20-colour table; an RGB(A) frame as it is."""
    return draw.label_panel(img) if img.ndim == 2 else img[..., :3]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--capture-dir", required=True)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--output", default="segmentation_demo.png")
    args = p.parse_args(argv)

    names, imgs = load_frames(args.capture_dir, args.frames)
    draw.titled([Path(n).stem for n in names])
    cols = min(4, len(imgs))
    write_png(args.output, draw.sheet([label_or_image(i) for i in imgs], cols, CELL))
    print(f"wrote {args.output} ({len(imgs)} frames)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
