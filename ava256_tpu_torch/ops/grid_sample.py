# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""2D grid sampling and bilinear resize with NHWC at the interface.

- ``grid_sample_2d`` is ``F.grid_sample(mode="bilinear",
  padding_mode="zeros")``, the semantics ``ava256_tpu.ops.grid_sample``
  reimplements (its packed neighbourhood form is a TPU gather trick).
- ``resize_bilinear`` is half-pixel-centre bilinear resampling without
  antialiasing (``jax.image.resize(..., "bilinear", antialias=False)``); at
  the border the JAX kernel renormalizes its weights, which is the same as
  ``F.interpolate``'s clamp of the source coordinate.

Dtypes follow JAX's promotion: a bfloat16 image sampled on a float32 grid
gives float32 (JAX multiplies the bfloat16 corners by float32 weights).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def grid_sample_2d(img: torch.Tensor, grid: torch.Tensor,
                   align_corners: bool = False) -> torch.Tensor:
    """img [N, H, W, C], grid [N, Ho, Wo, 2] with (x, y) in [-1, 1]
    -> [N, Ho, Wo, C], in the promoted dtype of img and grid."""
    dtype = torch.promote_types(img.dtype, grid.dtype)
    out = F.grid_sample(img.permute(0, 3, 1, 2).to(dtype), grid.to(dtype), mode="bilinear",
                        padding_mode="zeros", align_corners=align_corners)
    return out.permute(0, 2, 3, 1)


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """img [N, H, W, C] -> [N, out_hw[0], out_hw[1], C]."""
    out = F.interpolate(img.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                        align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1)
