# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""RGB decoder, as in ``ava256_tpu.models.decoders.rgb``: the geometry
decoder's tower pattern, its input code also conditioned on the viewing
direction through a small MLP; the imsize^2 x (boxsize * 3) slab becomes
[N, K, bs, bs, bs, 3] box colors."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ava256_tpu_torch.models.decoders.geometry import add_bias, tower_sizes
from ava256_tpu_torch.ops.layers import (
    LEAKY_GAIN, Conv2dWN, ConvTranspose2dWN, LinearWN, leaky_relu, nchw_to_nhwc, nhwc_to_nchw)


class RGBDecoder(nn.Module):
    def __init__(self, imsize: int, nboxes: int, boxsize: int, outch: int = 3,
                 viewcond: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.imsize, self.nboxes, self.boxsize, self.outch = imsize, nboxes, boxsize, outch
        self.viewcond = viewcond
        sizes = tower_sizes(imsize, 32 + (8 if viewcond else 0), boxsize * outch)
        self.nlayers = len(sizes) - 1
        self.encmod = Conv2dWN(16, 16, 1, gain=LEAKY_GAIN, dtype=dtype)
        if viewcond:
            self.viewmod0 = LinearWN(3, 16, gain=LEAKY_GAIN, dtype=dtype)
            self.viewmod1 = LinearWN(16, 8 * 4 * 4, gain=LEAKY_GAIN, dtype=dtype)
        for i in range(self.nlayers):
            last = i == self.nlayers - 1
            setattr(self, f"t{i}", ConvTranspose2dWN(sizes[i], sizes[i + 1], 4, 2, 1,
                                                     gain=1.0 if last else LEAKY_GAIN,
                                                     dtype=dtype))
        self.slab_bias = nn.Parameter(torch.zeros(imsize, imsize, boxsize * outch))

    def forward(self, ex_code: torch.Tensor, id_code: torch.Tensor,
                id_biases: List[torch.Tensor], view: Optional[torch.Tensor]) -> torch.Tensor:
        """ex_code/id_code [N, 4, 4, 16], id_biases NHWC texture pyramid,
        view [N, 3] unit view direction -> [N, K, bs, bs, bs, outch], float32
        (the float32 slab bias promotes it, as in JAX)."""
        n = ex_code.shape[0]
        z = leaky_relu(self.encmod(nhwc_to_nchw(ex_code)))
        x = torch.cat([z, nhwc_to_nchw(id_code)], dim=1)
        if self.viewcond:
            if view is None:
                raise ValueError("viewcond=True requires a view direction")
            v = leaky_relu(self.viewmod1(leaky_relu(self.viewmod0(view))))
            x = torch.cat([v.reshape(n, 4, 4, 8).permute(0, 3, 1, 2), x], dim=1)
        for i in range(self.nlayers):
            xx = getattr(self, f"t{i}")(x)
            if i < self.nlayers - 1:
                xx = leaky_relu(xx)
            x = add_bias(xx, id_biases)

        tex = nchw_to_nhwc(x) + self.slab_bias[None]
        bs = self.boxsize
        nh = int(np.sqrt(self.nboxes))
        rgb = tex.reshape(n, nh, bs, nh, bs, bs, self.outch).permute(0, 1, 3, 5, 2, 4, 6)
        return rgb.reshape(n, self.nboxes, bs, bs, bs, self.outch)
