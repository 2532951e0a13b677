# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Geometry decoder, as in ``ava256_tpu.models.decoders.geometry``: a
transposed-conv tower from the [expression ‖ identity] code to an
imsize^2 x boxsize opacity slab, adding the identity bias pyramid at every
matching level (scaled by 1/sqrt(2)), with two early-exit heads: a 9-channel
motion map at ``motion_size`` (one SRT residual per primitive) and a
3-channel geometry image at ``geo_size`` sampled back to the mesh vertices."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ava256_tpu_torch.ops.grid_sample import grid_sample_2d
from ava256_tpu_torch.ops.layers import (
    LEAKY_GAIN, Conv2dWN, ConvTranspose2dWN, leaky_relu, nchw_to_nhwc, nhwc_to_nchw, weak)


def vertex_uv_coords(uv: np.ndarray, tri: np.ndarray, uvtri: np.ndarray,
                     nvtx: int) -> np.ndarray:
    """Per-vertex UV sampling coordinates in [-1, 1], [nvtx, 1, 2]: the first
    UV coordinate any face assigns to the vertex, scanning faces in order."""
    uvspervert = np.zeros((nvtx,), dtype=np.int64)
    seen = np.zeros((nvtx,), dtype=bool)
    for fi in range(tri.shape[0]):
        for fv in range(3):
            v = tri[fi, fv]
            if not seen[v]:
                uvspervert[v] = uvtri[fi, fv]
                seen[v] = True
    coords = uv[uvspervert].astype(np.float32) * 2.0 - 1.0
    return coords[:, None, :]


def tower_sizes(imsize: int, inch: int, boxsize: int) -> List[int]:
    """Deconv tower channel schedule (1024 is the reference's)."""
    if imsize == 1024:
        return [inch, 256, 128, 128, 64, 64, 32, 16, boxsize]
    if imsize == 512:
        return [inch, 128, 128, 64, 64, 32, 16, boxsize]
    if imsize == 256:
        return [inch, 128, 64, 64, 32, 16, boxsize]
    raise ValueError(f"Unsupported image size: {imsize}")


def add_bias(xx: torch.Tensor, id_bias: List[torch.Tensor]) -> torch.Tensor:
    """(xx + b) / sqrt(2) with the NHWC pyramid level of xx's size and
    channel count, or xx where none matches. The float32 pyramid promotes a
    bfloat16 xx to float32, as in JAX; the next layer casts it back."""
    for b in id_bias:
        if b.shape[1] == xx.shape[2] and b.shape[-1] == xx.shape[1]:
            return (xx + nhwc_to_nchw(b)) * (1.0 / np.sqrt(2.0))
    return xx


class GeometryDecoder(nn.Module):
    def __init__(self, uv: np.ndarray, tri: np.ndarray, uvtri: np.ndarray, nvtx: int,
                 motion_size: int, geo_size: int, imsize: int, nboxes: int, boxsize: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.motion_size, self.geo_size = motion_size, geo_size
        self.imsize, self.nboxes, self.boxsize = imsize, nboxes, boxsize
        sizes = tower_sizes(imsize, 32, boxsize)
        self.nlayers = len(sizes) - 1
        self.encmod = Conv2dWN(16, 16, 1, gain=LEAKY_GAIN, dtype=dtype)
        for i in range(self.nlayers):
            last = i == self.nlayers - 1
            setattr(self, f"t{i}", ConvTranspose2dWN(sizes[i], sizes[i + 1], 4, 2, 1,
                                                     gain=1.0 if last else LEAKY_GAIN,
                                                     dtype=dtype))
        # level i outputs 8 * 2^i pixels
        ch_at = {8 * 2**i: sizes[i + 1] for i in range(self.nlayers)}
        self.motion0 = Conv2dWN(ch_at[motion_size], 64, 1, gain=LEAKY_GAIN, dtype=dtype)
        self.motion1 = Conv2dWN(64, 9, 1, dtype=dtype)
        self.geo0 = Conv2dWN(ch_at[geo_size], 64, 1, gain=LEAKY_GAIN, dtype=dtype)
        self.geo1 = Conv2dWN(64, 3, 1, dtype=dtype)
        self.slab_bias = nn.Parameter(torch.zeros(imsize, imsize, boxsize))
        self.register_buffer(
            "vert_coords",
            torch.as_tensor(vertex_uv_coords(np.asarray(uv), np.asarray(tri), np.asarray(uvtri),
                                             nvtx)),
            persistent=False)

    def forward(self, ex_enc: torch.Tensor, id_enc: torch.Tensor,
                id_bias: List[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """ex_enc/id_enc [N, 4, 4, 16], id_bias NHWC pyramid (deepest first).
        Returns opacity [N, K, bs, bs, bs, 1], geo [N, nvtx, 3], and the
        primpos / primrvec / primscale residuals [N, K, 3]. Opacity and geo
        are float32 (the float32 slab bias and sampling grid promote them, as
        in JAX), the residuals in the compute dtype."""
        n = ex_enc.shape[0]
        z = leaky_relu(self.encmod(nhwc_to_nchw(ex_enc)))
        x = torch.cat([z, nhwc_to_nchw(id_enc)], dim=1)
        mot = geo_map = None
        for i in range(self.nlayers):
            xx = getattr(self, f"t{i}")(x)
            if i < self.nlayers - 1:
                xx = leaky_relu(xx)
            x = add_bias(xx, id_bias)
            if x.shape[2] == self.motion_size:
                mot = self.motion1(leaky_relu(self.motion0(x)))
            if x.shape[2] == self.geo_size:
                geo_map = self.geo1(leaky_relu(self.geo0(x)))

        x = nchw_to_nhwc(x)
        opacity_slab = torch.exp((x + self.slab_bias[None]) * 0.1)

        mot = nchw_to_nhwc(mot).reshape(n, self.nboxes, 9)
        c = weak(0.01, mot)
        primposresid = mot[..., 0:3] * c
        primrvecresid = mot[..., 3:6] * c
        primscaleresid = torch.exp(c * mot[..., 6:9])

        coords = self.vert_coords[None].expand(n, -1, -1, -1)
        geo = torch.mean(grid_sample_2d(nchw_to_nhwc(geo_map), coords, align_corners=False),
                         dim=2)

        bs = self.boxsize
        nh = int(np.sqrt(self.nboxes))
        opacity = opacity_slab.reshape(n, nh, bs, nh, bs, bs).permute(0, 1, 3, 5, 2, 4)
        opacity = opacity.reshape(n, self.nboxes, bs, bs, bs, 1)
        return opacity, geo, primposresid, primrvecresid, primscaleresid
