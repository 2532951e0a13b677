# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Per-camera x per-identity affine color calibration, as in
``ava256_tpu.models.colorcal``."""

from __future__ import annotations

import torch
from torch import nn


class Colorcal(nn.Module):
    def __init__(self, ncams: int, nident: int):
        super().__init__()
        self.wcam = nn.Parameter(torch.ones(ncams, 3))
        self.bcam = nn.Parameter(torch.zeros(ncams, 3))
        self.wident = nn.Parameter(torch.zeros(nident, 3))
        self.bident = nn.Parameter(torch.zeros(nident, 3))

    def forward(self, image: torch.Tensor, camindex: torch.Tensor,
                idindex: torch.Tensor) -> torch.Tensor:
        """image [N, H, W, 3]; camindex/idindex [N] int."""
        w = self.wcam[camindex] + self.wident[idindex]
        b = self.bcam[camindex] + self.bident[idindex]
        return w[:, None, None, :] * image + b[:, None, None, :]
