# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Identity encoder, as in ``ava256_tpu.models.encoders.identity``: a
subject's neutral geometry image and neutral texture -> identity codes
(z_geo / z_tex, [N, 4, 4, 16]) and two bias pyramids (deepest first), each
level resampled through a learned low-resolution warp field. Outputs are
NHWC; the JAX package's packed one-gather sampling is a TPU trick, so each
pyramid level is sampled on its own here."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from ava256_tpu_torch.ops.geomap import generate_geomap
from ava256_tpu_torch.ops.grid_sample import grid_sample_2d, resize_bilinear
from ava256_tpu_torch.ops.layers import (
    LEAKY_GAIN, Conv2dWN, leaky_relu, nchw_to_nhwc, nhwc_to_nchw, remat)

_ESIZE = [3, 16, 32, 64, 64, 128, 128, 256, 256]
_BSIZE = [3, 16, 32, 64, 64, 128, 128, 256, 256]


def _nlayers(imsize: int) -> int:
    nlayers = int(np.log2(imsize)) - 2  # downsample to 4x4
    if 2 ** (nlayers + 2) != imsize or nlayers < 1 or nlayers > len(_ESIZE) - 1:
        raise ValueError(f"Unsupported image size: {imsize}")
    return nlayers


class UnetEncoder(nn.Module):
    """Downsampling encoder emitting a code and a bias pyramid (NCHW)."""

    def __init__(self, imsize: int, channel_mult: int = 1):
        super().__init__()
        self.nlayers = _nlayers(imsize)
        esize = [_ESIZE[0]] + [c * channel_mult for c in _ESIZE[1: self.nlayers + 1]]
        for i in range(self.nlayers):
            setattr(self, f"b{i}", Conv2dWN(esize[i], _BSIZE[i], 1,
                                            gain=LEAKY_GAIN if i > 0 else 1.0))
            setattr(self, f"e{i}", Conv2dWN(esize[i], esize[i + 1], 4, 2, 1, gain=LEAKY_GAIN))
        self.enc = Conv2dWN(esize[self.nlayers], 16, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        biases: List[torch.Tensor] = []
        for i in range(self.nlayers):
            b = getattr(self, f"b{i}")(x)
            biases.insert(0, leaky_relu(b) if i > 0 else b)
            x = leaky_relu(getattr(self, f"e{i}")(x))
        return self.enc(x), biases


class GeoTexCombiner(nn.Module):
    """Cross-talk between the geometry and texture pyramids via 1x1 convs.
    ``channels`` lists each level's channel count, deepest first."""

    def __init__(self, channels: List[int]):
        super().__init__()
        self.nlevels = len(channels)
        for i, ch in enumerate(channels):
            setattr(self, f"t2g{i}", Conv2dWN(ch, ch, 1, gain=LEAKY_GAIN))
            setattr(self, f"g2t{i}", Conv2dWN(ch, ch, 1, gain=LEAKY_GAIN))
            setattr(self, f"g{i}", Conv2dWN(2 * ch, ch, 1, gain=LEAKY_GAIN))
            setattr(self, f"t{i}", Conv2dWN(2 * ch, ch, 1, gain=LEAKY_GAIN))

    def forward(self, b_geo: List[torch.Tensor], b_tex: List[torch.Tensor]):
        out_geo, out_tex = [], []
        for i in range(self.nlevels):
            t2g = leaky_relu(getattr(self, f"t2g{i}")(b_tex[i]))
            g2t = leaky_relu(getattr(self, f"g2t{i}")(b_geo[i]))
            cg = torch.cat([b_geo[i], t2g], dim=1)
            ct = torch.cat([b_tex[i], g2t], dim=1)
            out_geo.append(leaky_relu(getattr(self, f"g{i}")(cg)))
            out_tex.append(leaky_relu(getattr(self, f"t{i}")(ct)))
        return out_geo, out_tex


class IdentityEncoder(nn.Module):
    def __init__(self, uv_tidx: np.ndarray, uv_bary: np.ndarray, wsize: int = 128):
        super().__init__()
        self.register_buffer("uv_tidx", torch.as_tensor(np.asarray(uv_tidx), dtype=torch.int64),
                             persistent=False)
        self.register_buffer("uv_bary", torch.as_tensor(np.asarray(uv_bary), dtype=torch.float32),
                             persistent=False)
        imsize = self.uv_tidx.shape[-1]
        self.wsize = wsize
        self.geo = UnetEncoder(imsize)
        self.tex = UnetEncoder(imsize)
        self.comb = GeoTexCombiner(list(reversed(_BSIZE[: _nlayers(imsize)])))
        self.warp_bias = nn.Parameter(torch.zeros(1, wsize, wsize, 2))
        xs = np.linspace(-1.0, 1.0, wsize, dtype=np.float32)
        xg, yg = np.meshgrid(xs, xs)
        self.register_buffer("identity_grid", torch.as_tensor(np.stack([xg, yg], axis=-1)[None]),
                             persistent=False)

    def forward(self, neut_verts: torch.Tensor, neut_avgtex: torch.Tensor
                ) -> Dict[str, object]:
        """neut_verts [N, V, 3], neut_avgtex [N, M, M, 3] -> {"z_geo", "z_tex":
        [N, 4, 4, 16], "b_geo", "b_tex": NHWC bias pyramids, deepest first}."""
        geo_img = generate_geomap(neut_verts, self.uv_tidx, self.uv_bary)
        # the UNets and the warp sampling are recomputed in the backward pass
        z_geo, b_geo = remat(self.geo, nhwc_to_nchw(geo_img))
        z_tex, b_tex = remat(self.tex, nhwc_to_nchw(neut_avgtex))
        b_geo, b_tex = self.comb(b_geo, b_tex)

        # learned warp: identity grid + trainable bias (scaled by 1/wsize),
        # one field shared by every batch item and both pyramids
        warp = self.identity_grid + self.warp_bias / self.wsize
        n = neut_verts.shape[0]

        def apply_warp(warp, *levels):
            out = []
            for x in levels:
                grid = resize_bilinear(warp, x.shape[2:]).expand(n, -1, -1, -1)
                out.append(grid_sample_2d(nchw_to_nhwc(x), grid, align_corners=False))
            return out

        out = remat(apply_warp, warp, *b_geo, *b_tex)
        out_geo, out_tex = out[: len(b_geo)], out[len(b_geo):]
        return {"z_geo": nchw_to_nhwc(z_geo), "z_tex": nchw_to_nhwc(z_tex),
                "b_geo": out_geo, "b_tex": out_tex}
