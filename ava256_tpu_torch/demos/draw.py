# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The demos' figures in numpy: uint8 RGB panels, tiled into one sheet that
the demos write with ``utils.write_png``. No text is drawn; the demos print
each panel's title instead (``titled``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

LIME = (0, 255, 0)
BLUE = (31, 119, 180)  # the first colour of matplotlib's default cycle
GREY = (190, 190, 190)
WHITE = 255
ELEV, AZIM = 30.0, -60.0  # degrees: matplotlib's default view of a 3D axes
# matplotlib's tab20, the table the reference shows label maps through
TAB20 = np.array([
    (31, 119, 180), (174, 199, 232), (255, 127, 14), (255, 187, 120), (44, 160, 44),
    (152, 223, 138), (214, 39, 40), (255, 152, 150), (148, 103, 189), (197, 176, 213),
    (140, 86, 75), (196, 156, 148), (227, 119, 194), (247, 182, 210), (127, 127, 127),
    (199, 199, 199), (188, 189, 34), (219, 219, 141), (23, 190, 207), (158, 218, 229),
], np.uint8)


def image_panel(img: np.ndarray) -> np.ndarray:
    """A float [H, W, 3] image in 0..255 (a dataset item's) -> uint8 RGB."""
    return np.rint(np.clip(np.asarray(img, np.float32), 0.0, 255.0)).astype(np.uint8)


def splat(panel: np.ndarray, px, py, color, radius: int = 0) -> np.ndarray:
    """``panel`` with points (pixel coordinates ``px``, ``py``) painted in
    ``color`` as squares of side 2 * radius + 1; points off the panel are
    dropped. Returns a copy."""
    out = panel.copy()
    h, w = out.shape[:2]
    px, py = np.asarray(px, np.float64).ravel(), np.asarray(py, np.float64).ravel()
    keep = np.isfinite(px) & np.isfinite(py)
    x, y = np.floor(px[keep]).astype(np.int64), np.floor(py[keep]).astype(np.int64)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            xs, ys = x + dx, y + dy
            on = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
            out[ys[on], xs[on]] = color
    return out


def texture_panel(tex: np.ndarray) -> np.ndarray:
    """A texture min-max normalized to 0..255, as the reference shows it."""
    tex = np.asarray(tex, np.float32)
    tex = (tex - tex.min()) / max(float(tex.max() - tex.min()), 1e-6)
    return image_panel(np.clip(tex, 0.0, 1.0) * 255.0)


def label_panel(labels: np.ndarray) -> np.ndarray:
    """A label map [H, W] through the fixed 20-colour table (label mod 20)."""
    return TAB20[np.asarray(labels).astype(np.int64) % len(TAB20)]


def blank_panel(h: int, w: int) -> np.ndarray:
    return np.full((h, w, 3), WHITE, np.uint8)


def points3d_panel(xyz: np.ndarray, size: int = 512, radius: int = 1) -> np.ndarray:
    """A point set [N, 3] in an orthographic view of its own three axes:
    each axis scaled to its range, as a 3D scatter's axes are, seen from
    matplotlib's default elevation and azimuth, z up, with the box of the
    axes' ranges drawn in grey."""
    xyz = np.asarray(xyz, np.float64)[:, :3]
    lo, hi = xyz.min(axis=0), xyz.max(axis=0)
    unit = (xyz - (lo + hi) / 2) / np.maximum((hi - lo) / 2, 1e-12)  # each axis in [-1, 1]
    e, a = np.radians(ELEV), np.radians(AZIM)
    right = np.array([-np.sin(a), np.cos(a), 0.0])
    up = np.array([-np.sin(e) * np.cos(a), -np.sin(e) * np.sin(a), np.cos(e)])

    def to_px(p):
        # a corner of the unit box lies at most sqrt(3) from the centre
        s = (size - 2 * radius - 1) / (2 * np.sqrt(3.0))
        return size / 2 + s * (p @ right), size / 2 - s * (p @ up)

    panel = blank_panel(size, size)
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], float)
    t = np.linspace(0.0, 1.0, 2 * size)[:, None]
    for i in range(8):
        for j in range(i + 1, 8):
            if np.sum(corners[i] != corners[j]) == 1:  # an edge of the box
                panel = splat(panel, *to_px(corners[i] + t * (corners[j] - corners[i])), GREY)
    return splat(panel, *to_px(unit), BLUE, radius)


def fit_height(panel: np.ndarray, h: int) -> np.ndarray:
    """``panel`` scaled by nearest neighbour to height ``h``."""
    ph, pw = panel.shape[:2]
    w = max(1, round(pw * h / ph))
    rows = np.minimum((np.arange(h) + 0.5) * ph / h, ph - 1).astype(np.int64)
    cols = np.minimum((np.arange(w) + 0.5) * pw / w, pw - 1).astype(np.int64)
    return panel[rows][:, cols]


def sheet(panels: Sequence[np.ndarray], cols: int, height: int, gap: int = 8) -> np.ndarray:
    """Panels scaled to one height and tiled row by row, ``cols`` a row, on
    white with a ``gap`` between them."""
    fitted = [fit_height(p, height) for p in panels]
    cell_w = max(p.shape[1] for p in fitted)
    rows = -(-len(fitted) // cols)
    out = blank_panel(rows * height + (rows + 1) * gap, cols * cell_w + (cols + 1) * gap)
    for i, p in enumerate(fitted):
        r, c = divmod(i, cols)
        y, x = gap + r * (height + gap), gap + c * (cell_w + gap)
        out[y:y + height, x:x + p.shape[1]] = p
    return out


def titled(titles: Sequence[str]) -> None:
    """Print the panels' titles, one line each."""
    for i, title in enumerate(titles):
        print(f"panel {i + 1}: {title}")

