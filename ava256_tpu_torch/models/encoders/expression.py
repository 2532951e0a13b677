# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Expression encoder, as in ``ava256_tpu.models.encoders.expression``:
per-frame deltas (vertices minus neutral vertices rasterized as a geometry
image; average texture minus neutral texture) through conv towers into a
[N, 4, 4, 64] expression code (NHWC)."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ava256_tpu_torch.ops.geomap import generate_geomap
from ava256_tpu_torch.ops.graphs import GraphCache
from ava256_tpu_torch.ops.layers import ConvSeq, nchw_to_nhwc, nhwc_to_nchw, remat


def _conv(features: int, k: int = 4, s: int = 2, p: int = 1) -> dict:
    return dict(features=features, kernel_size=k, strides=s, padding=p)


class ExpressionEncoder(nn.Module):
    """uv_tidx/uv_bary: per-texel triangle corner indices and barycentrics
    [3, M, M]; the textures are M x M too."""

    def __init__(self, uv_tidx: np.ndarray, uv_bary: np.ndarray, channel_mult: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        C = channel_mult
        self.register_buffer("uv_tidx", torch.as_tensor(np.asarray(uv_tidx), dtype=torch.int64),
                             persistent=False)
        self.register_buffer("uv_bary", torch.as_tensor(np.asarray(uv_bary), dtype=torch.float32),
                             persistent=False)
        imsize = self.uv_tidx.shape[-1]
        n_down = int(math.log2(imsize)) - 5
        if n_down < 1 or 2 ** (n_down + 5) != imsize:
            raise ValueError(f"Unsupported image size: {imsize}")
        self.tex = ConvSeq(3, [_conv(16 * C), _conv(32 * C), _conv(64 * C)],
                           final_activation=True, dtype=dtype)
        self.geo = ConvSeq(3, [_conv(16 * C), _conv(32 * C), _conv(32 * C)],
                           final_activation=True, dtype=dtype)
        lead = [128 * C, 256 * C, 256 * C, 512 * C][: n_down - 1]
        self.comb = ConvSeq(
            96 * C,
            [_conv(ch) for ch in lead] + [
                _conv(256 * C, k=3, s=1, p=1),
                _conv(128 * C, k=3, s=1, p=1),
                _conv(64 * C, k=3, s=1, p=1),
                _conv(64),
            ],
            final_activation=True,
            dtype=dtype,
        )
        self.graphs = GraphCache()  # replays the forward under inference (ops/graphs.py)

    def forward(self, verts: torch.Tensor, avgtex: torch.Tensor, neut_verts: torch.Tensor,
                neut_avgtex: torch.Tensor) -> torch.Tensor:
        """verts/neut_verts [N, V, 3]; avgtex/neut_avgtex [N, M, M, 3] ->
        [N, 4, 4, 64]."""
        return self.graphs(self, self._forward, verts, avgtex, neut_verts, neut_avgtex)

    def _forward(self, verts: torch.Tensor, avgtex: torch.Tensor, neut_verts: torch.Tensor,
                 neut_avgtex: torch.Tensor) -> torch.Tensor:
        geo_img = generate_geomap(verts - neut_verts, self.uv_tidx, self.uv_bary)
        # each conv stack is recomputed in the backward pass
        tex = remat(self.tex, nhwc_to_nchw(avgtex - neut_avgtex))
        geo = remat(self.geo, nhwc_to_nchw(geo_img))
        return nchw_to_nhwc(remat(self.comb, torch.cat([tex, geo], dim=1)))
