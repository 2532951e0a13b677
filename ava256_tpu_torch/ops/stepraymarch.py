# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Single-volume step raymarcher, the port of ``ava256_tpu.ops.stepraymarch``:
one warped RGBA volume marched in fixed steps, with additive (saturating)
or multiplicative (front-to-back alpha compositing) accumulation. A
baseline and debugging renderer; the MVP raymarchers do the production work.
"""

from __future__ import annotations

from typing import Optional

import torch

from ava256_tpu_torch.ops.raymarch_ref import grid_sample_3d


def step_raymarch(
    raypos: torch.Tensor,
    raydir: torch.Tensor,
    stepsize: float,
    tminmax: torch.Tensor,
    template: torch.Tensor,
    warp: Optional[torch.Tensor] = None,
    accum: str = "add",
    max_steps: int = 1024,
) -> torch.Tensor:
    """raypos/raydir [N, H, W, 3], tminmax [N, H, W, 2], template
    [N, D, H', W', 4] (one RGBA volume per batch item), warp [N, D, H', W', 3]
    or None; ``accum`` "add" (saturating) or "mult" (alpha compositing).
    Returns rayrgba [N, H, W, 4]."""
    if accum not in ("add", "mult"):
        raise ValueError(f"accum must be 'add' or 'mult', got {accum!r}")
    tmin, tmax = tminmax[..., 0], tminmax[..., 1]
    rgba = torch.zeros(raypos.shape[:-1] + (4,), dtype=raypos.dtype, device=raypos.device)
    trans = torch.ones(raypos.shape[:-1] + (1,), dtype=raypos.dtype, device=raypos.device)
    for i in range(max_steps):
        t = tmin + stepsize * i
        pos = raypos + raydir * t[..., None]
        valid = ((t >= tmin) & (t < tmax)).to(raypos.dtype)[..., None]
        inbox = torch.all((pos >= -1.0) & (pos <= 1.0), dim=-1, keepdim=True).to(raypos.dtype)
        coords = pos if warp is None else grid_sample_3d(warp, pos)
        sample = grid_sample_3d(template, coords)
        alpha = sample[..., 3:4] * stepsize * valid * inbox
        rgb = sample[..., 0:3]
        if accum == "add":
            acc_a = rgba[..., 3:4]
            contrib = torch.clamp(acc_a + alpha, max=1.0) - acc_a
            rgba = rgba + contrib * torch.cat([rgb, torch.ones_like(alpha)], dim=-1)
        else:
            a = torch.clamp(alpha, 0.0, 1.0)
            contrib = trans * a
            rgba = rgba + contrib * torch.cat([rgb, torch.ones_like(a)], dim=-1)
            trans = trans * (1.0 - a)
    return rgba
