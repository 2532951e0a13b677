# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Camera-ray generation, as in ``ava256_tpu.ops.raydirs``: pinhole ray
directions, camera position in volume units, and the slab entry/exit of the
[-1, 1]^3 cube. No gradient flows through it."""

from __future__ import annotations

from typing import Tuple

import torch


@torch.no_grad()
def compute_raydirs(viewpos: torch.Tensor, viewrot: torch.Tensor, focal: torch.Tensor,
                    princpt: torch.Tensor, pixelcoords: torch.Tensor,
                    volradius: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """viewpos [N, 3], viewrot [N, 3, 3] (world-to-camera rows), focal and
    princpt [N, 2], pixelcoords [N, H, W, 2] -> raypos, raydir [N, H, W, 3]
    and tminmax [N, H, W, 2] (tmin clamped to >= 0)."""
    p = (pixelcoords - princpt[:, None, None, :]) / focal[:, None, None, :]
    d = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    raydir = torch.einsum("nij,nhwi->nhwj", viewrot, d)
    raydir = raydir / torch.sqrt(torch.sum(raydir**2, dim=-1, keepdim=True))

    raypos = (viewpos / volradius)[:, None, None, :] * torch.ones_like(raydir)

    t1 = (-1.0 - raypos) / raydir
    t2 = (1.0 - raypos) / raydir
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    tminmax = torch.stack([torch.clamp(tmin, min=0.0), tmax], dim=-1)
    return raypos, raydir, tminmax
