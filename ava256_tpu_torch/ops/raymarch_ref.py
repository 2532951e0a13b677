# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Oracle MVP raymarcher in plain PyTorch, a port of
``ava256_tpu.ops.raymarch_ref``. It is the semantic anchor of the CPU tests;
the production path is ``raymarch_cuda``.

For each ray, march fixed steps of ``stepsize`` from tmin to tmax. At each
step, every primitive k contributes:

    y      = primscale_k * ((pos - primpos_k) @ primrot_k)      (local coords)
    fade   = exp(-fadescale * sum(|y|^fadeexp))
    valid  = all(|y| <= 1) and (tmin <= t < tmax)
    sample = trilinear(template_k, warp_k(y) or y)   (align_corners=True)
    alpha  = sample_a * fade * stepsize * valid
    contrib = min(acc_alpha + alpha, 1) - acc_alpha              (saturating)
    rgba  += contrib * [sample_rgb, 1]

O(K * steps) per ray: for tests and tiny scenes only.
"""

from __future__ import annotations

from typing import Optional

import torch


def grid_sample_3d(vol: torch.Tensor, coords: torch.Tensor,
                   align_corners: bool = True) -> torch.Tensor:
    """Trilinear sampling with zero padding.

    vol: [*B, D, H, W, C] channels-last volumes; coords: [*B, ..., 3]
    normalized (x, y, z) in [-1, 1] (x indexes W, y H, z D), with the same
    leading batch dims *B as ``vol``. Returns [*B, ..., C].
    """
    nb = vol.ndim - 4
    bshape = vol.shape[:nb]
    d, h, w, c = vol.shape[nb:]
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    if align_corners:
        fx = (x + 1.0) / 2.0 * (w - 1)
        fy = (y + 1.0) / 2.0 * (h - 1)
        fz = (z + 1.0) / 2.0 * (d - 1)
    else:
        fx = ((x + 1.0) * w - 1.0) / 2.0
        fy = ((y + 1.0) * h - 1.0) / 2.0
        fz = ((z + 1.0) * d - 1.0) / 2.0
    x0f, y0f, z0f = torch.floor(fx), torch.floor(fy), torch.floor(fz)
    wx1, wy1, wz1 = fx - x0f, fy - y0f, fz - z0f

    flat = vol.reshape(-1, d * h * w, c)  # [B, DHW, C]
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi, zi = x0f + dx, y0f + dy, z0f + dz
                mask = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
                        & (zi >= 0) & (zi <= d - 1))
                xc = torch.clamp(xi, 0, w - 1).long()
                yc = torch.clamp(yi, 0, h - 1).long()
                zc = torch.clamp(zi, 0, d - 1).long()
                idx = ((zc * h + yc) * w + xc).reshape(flat.shape[0], -1)
                vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
                vals = vals.reshape(bshape + xi.shape[nb:] + (c,))
                wgt = ((wx1 if dx else 1.0 - wx1) * (wy1 if dy else 1.0 - wy1)
                       * (wz1 if dz else 1.0 - wz1))
                out = out + vals * mask[..., None] * wgt[..., None]
    return out


def mvp_raymarch_reference(
    raypos: torch.Tensor,
    raydir: torch.Tensor,
    stepsize: float,
    tminmax: torch.Tensor,
    primpos: torch.Tensor,
    primrot: torch.Tensor,
    primscale: torch.Tensor,
    template: torch.Tensor,
    warp: Optional[torch.Tensor] = None,
    fadescale: float = 8.0,
    fadeexp: float = 8.0,
    max_steps: Optional[int] = None,
    within_step: str = "sequential",
) -> torch.Tensor:
    """raypos/raydir [N, H, W, 3], tminmax [N, H, W, 2], primpos [N, K, 3],
    primrot [N, K, 3, 3] (columns are local axes), primscale [N, K, 3],
    template [N, K, D, H, W, 4], warp [N, K, D, H, W, 3] or None.
    ``within_step``: "sequential" composites prims in index order inside a
    step; "summed" adds every primitive's density at a step before
    saturating (the kernel's rule). Returns rayrgba [N, H, W, 4]."""
    K = primpos.shape[1]
    tmin, tmax = tminmax[..., 0], tminmax[..., 1]
    if max_steps is None:
        max_steps = 1024
    primrot = primrot.reshape(primrot.shape[:2] + (3, 3))

    acc = torch.zeros(raypos.shape[:-1] + (4,), dtype=raypos.dtype, device=raypos.device)
    for i in range(max_steps):
        t = tmin + stepsize * i
        pos = raypos + raydir * t[..., None]
        tvalid = ((t >= tmin) & (t < tmax)).to(raypos.dtype)[..., None]

        rel = pos[:, None] - primpos[:, :, None, None]  # [N, K, H, W, 3]
        y0 = torch.einsum("nkhwi,nkij->nkhwj", rel, primrot) * primscale[:, :, None, None]
        fade = torch.exp(-fadescale * torch.sum(torch.abs(y0) ** fadeexp, dim=-1,
                                                keepdim=True))
        inbox = torch.all((y0 >= -1.0) & (y0 <= 1.0), dim=-1, keepdim=True).to(raypos.dtype)
        y1 = y0 if warp is None else grid_sample_3d(warp, y0)
        sample = grid_sample_3d(template, y1)  # [N, K, H, W, 4]

        rgb = sample[..., 0:3]
        alpha = sample[..., 3:4] * fade * stepsize * inbox * tvalid[:, None]

        if within_step == "summed":
            acc_a = acc[..., 3:4]
            total = torch.sum(alpha, dim=1)
            contrib = torch.clamp(acc_a + total, max=1.0) - torch.clamp(acc_a, max=1.0)
            share = contrib / torch.clamp(total, min=1e-12)
            crgb = torch.sum(alpha * rgb, dim=1) * share
            acc = acc + torch.cat([crgb, contrib], dim=-1)
            continue
        for k in range(K):
            acc_a = acc[..., 3:4]
            newalpha = acc_a + alpha[:, k]
            contrib = (torch.clamp(newalpha, max=1.0) - acc_a) * inbox[:, k] * tvalid
            acc = acc + contrib * torch.cat([rgb[:, k], torch.ones_like(acc_a)], dim=-1)
    return acc
