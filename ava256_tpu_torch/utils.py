# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Image strips and logging, as ``ava256_tpu.utils``: ``render_img`` tiles
rows of images into one PNG, ``setup_logging`` tags each line with the
host's name. The PNG is written here with ``zlib`` and ``struct`` (8-bit
grey, RGB or RGBA, no interlace), so no imaging package is needed."""

from __future__ import annotations

import logging
import platform
import struct
import sys
import zlib
from typing import Sequence

import numpy as np

_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type (grey, RGB, RGBA)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(img: np.ndarray, compresslevel: int = 6) -> bytes:
    """A uint8 [H, W], [H, W, 1], [H, W, 3] or [H, W, 4] array as the bytes
    of a PNG file (every row with filter type 0, none)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"write_png takes [H, W] or [H, W, 1|3|4], got {img.shape}")
    h, w, c = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), compresslevel))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 [H, W], [H, W, 1], [H, W, 3] or [H, W, 4] array as a PNG."""
    png = png_bytes(img)
    with open(path, "wb") as f:
        f.write(png)


def render_img(listsofimages: Sequence[Sequence[np.ndarray]], outpath: str) -> None:
    """Tile a list of rows of HWC images into one image and save it."""
    rows = [np.hstack([np.asarray(i) for i in images]) for images in listsofimages]
    rgb = np.vstack(rows)
    write_png(outpath, np.clip(rgb, 0, 255).astype(np.uint8))


class HostnameFilter(logging.Filter):
    hostname = platform.node()

    def filter(self, record):
        record.hostname = HostnameFilter.hostname
        return True


def setup_logging(level=logging.INFO) -> logging.Logger:
    root = logging.getLogger()
    root.setLevel(level)
    if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
        handler = logging.StreamHandler(sys.stdout)
        handler.setLevel(level)
        handler.addFilter(HostnameFilter())
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(hostname)s - %(name)s - %(levelname)s - %(message)s"
            )
        )
        root.addHandler(handler)
    return root
