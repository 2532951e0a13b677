# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Geometry-image rasterization: interpolate mesh vertices into a UV texture
by three row gathers and a barycentric blend (the gather form of
``ava256_tpu.ops.geomap``; its blocked-matmul form is a TPU layout)."""

from __future__ import annotations

import torch


def generate_geomap(geo: torch.Tensor, uv_tidx: torch.Tensor,
                    uv_bary: torch.Tensor) -> torch.Tensor:
    """geo [N, V, 3], uv_tidx [3, M, M] int, uv_bary [3, M, M] -> [N, M, M, 3]."""
    m = uv_tidx.shape[-1]
    out = None
    for k in range(3):
        vals = geo[:, uv_tidx[k].reshape(-1)]  # [N, M*M, 3]
        term = vals * uv_bary[k].reshape(1, -1, 1)
        out = term if out is None else out + term
    return out.reshape(geo.shape[0], m, m, 3)
