# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""ctypes bindings of the host data library ``csrc/dataio.cpp``, the port's
counterpart of ``ava256_tpu.native``: the bilinear resize of camera images
and the PNG row unfilter. The library is built with the host C++ compiler at
first use (``ops.cuda_lib.HostLib``); if it cannot be built, the caller gets
the compiler's error. There is no numpy fallback: it would give other pixels.

``resize_bilinear_u8_plain`` restates the resize's arithmetic in numpy, as a
yardstick for the library (tests, ``chip_smoke.py``); no data path calls it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ava256_tpu_torch.ops.cuda_lib import HostLib

_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_I64 = ctypes.c_int64


def _declare(lib: ctypes.CDLL) -> None:
    lib.ava_resize_bilinear_u8.restype = None
    lib.ava_resize_bilinear_u8.argtypes = [_U8, _I64, _I64, _I64, _U8, _I64, _I64]
    lib.ava_png_unfilter.restype = _I64
    lib.ava_png_unfilter.argtypes = [_U8, _I64, _I64, _I64, _U8]


DATAIO_LIB = HostLib("dataio.cpp", _declare)


def resize_bilinear_u8(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [h, w, C], bilinear with half-pixel centres
    (the arithmetic of ``ava256_tpu.native.resize_bilinear_u8``)."""
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_bilinear_u8 takes uint8 [H, W, C], got {img.dtype} "
                         f"{img.shape}")
    img = np.ascontiguousarray(img)
    dh, dw = (int(v) for v in out_hw)
    if dh <= 0 or dw <= 0:
        raise ValueError(f"resize_bilinear_u8: output size {out_hw}")
    dst = np.empty((dh, dw, img.shape[2]), np.uint8)
    DATAIO_LIB.lib().ava_resize_bilinear_u8(img, img.shape[0], img.shape[1], img.shape[2],
                                            dst, dh, dw)
    return dst


def resize_bilinear_u8_plain(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``resize_bilinear_u8``'s arithmetic in numpy float32, each product and
    sum rounded on its own (the library's build may fuse a multiply-add, so
    the two may differ by one level)."""
    sh, sw, _ = img.shape
    dh, dw = out_hw
    f32 = np.float32

    def axis(n_dst, n_src, next_of_clamped):
        f = (np.arange(n_dst, dtype=f32) + f32(0.5)) * (f32(n_src) / f32(n_dst)) - f32(0.5)
        fl = np.floor(f)
        i0 = fl.astype(np.int64)
        i1 = (np.clip(i0, 0, n_src - 1) if next_of_clamped else i0) + 1
        return np.clip(i0, 0, n_src - 1), np.clip(i1, 0, n_src - 1), (f - fl).astype(f32)

    # as in the library, the row below follows the clamped row, while the
    # column to the right follows the unclamped column
    y0, y1, wy = axis(dh, sh, True)
    x0, x1, wx = axis(dw, sw, False)
    wx = wx[None, :, None]
    r0, r1 = img[y0].astype(f32), img[y1].astype(f32)
    top = r0[:, x0] + (r0[:, x1] - r0[:, x0]) * wx
    bot = r1[:, x0] + (r1[:, x1] - r1[:, x0]) * wx
    v = top + (bot - top) * wy[:, None, None]
    return (v + f32(0.5)).astype(np.uint8)


def png_unfilter(raw: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of an inflated 8-bit image: ``raw`` holds
    ``height`` rows of one filter-type byte and ``rowbytes`` bytes; returns
    uint8 [height, rowbytes]. Raises ``ValueError`` on a filter type outside
    0-4 or a short buffer."""
    if isinstance(raw, (bytes, bytearray)):
        raw = np.frombuffer(raw, np.uint8)
    raw = np.ascontiguousarray(raw, dtype=np.uint8).reshape(-1)
    if raw.size != height * (rowbytes + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, the header says "
                         f"{height} rows of 1 + {rowbytes}")
    if bpp < 1:
        raise ValueError(f"png_unfilter: {bpp} bytes per pixel")
    out = np.empty((height, rowbytes), np.uint8)
    bad = DATAIO_LIB.lib().ava_png_unfilter(raw, height, rowbytes, bpp, out)
    if bad:
        raise ValueError(f"PNG row {bad - 1}: filter type {raw[(bad - 1) * (rowbytes + 1)]} "
                         "is not one of 0-4")
    return out
