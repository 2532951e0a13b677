# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Simple background model, as in ``ava256_tpu.models.bg``: per-camera and
per-identity embeddings plus a sin/cos encoding of screen coordinates
through a 1x1-conv MLP.

The JAX factory wraps this module in ``nn.remat`` so its full-resolution
256-channel activations are recomputed in the backward pass; here the
autoencoder calls it through ``ops.layers.remat``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ava256_tpu_torch.ops.layers import LEAKY_GAIN, Conv2d, Linear, leaky_relu


class BackgroundModelSimple(nn.Module):
    def __init__(self, ncams: int, nident: int):
        super().__init__()
        self.ncams = ncams
        self.nident = nident
        self.cammod0 = Linear(ncams, 256, gain=LEAKY_GAIN)
        self.cammod1 = Linear(256, 40)
        self.idmod0 = Linear(nident, 256, gain=LEAKY_GAIN)
        self.idmod1 = Linear(256, 40)
        for i in range(5):
            setattr(self, f"mlp{i}", Conv2d(120 if i == 0 else 256, 256, 1, gain=LEAKY_GAIN))
        self.mlp5 = Conv2d(256, 3, 1)
        self.register_buffer("freqs", torch.as_tensor((2.0 ** np.arange(10)) * np.pi,
                                                      dtype=torch.float32), persistent=False)

    def forward(self, camindex: torch.Tensor, idindex: torch.Tensor,
                samplecoords: torch.Tensor) -> torch.Tensor:
        """samplecoords [N, H, W, 2] in [-1, 1] -> [N, H, W, 3]."""
        n, h, w = samplecoords.shape[:3]
        dt = samplecoords.dtype
        camenc = self.cammod1(leaky_relu(self.cammod0(F.one_hot(camindex.long(),
                                                                self.ncams).to(dt))))
        idenc = self.idmod1(leaky_relu(self.idmod0(F.one_hot(idindex.long(),
                                                             self.nident).to(dt))))
        ang = samplecoords[..., None, :] * self.freqs[:, None]  # [N, H, W, 10, 2]
        posenc = torch.cat([torch.sin(ang).reshape(n, h, w, -1),
                            torch.cos(ang).reshape(n, h, w, -1)], dim=-1).permute(0, 3, 1, 2)
        x = torch.cat([camenc[:, :, None, None].expand(n, 40, h, w),
                       idenc[:, :, None, None].expand(n, 40, h, w), posenc], dim=1)
        for i in range(5):
            x = leaky_relu(getattr(self, f"mlp{i}")(x))
        x = self.mlp5(x)
        return (x * 25.0 + 100.0).permute(0, 2, 3, 1)
