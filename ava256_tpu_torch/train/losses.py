# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Training losses, as in ``ava256_tpu.train.losses``: image L1, vertex L1 on
denormalized vertices, the primitive-volume penalty and the stable KL
divergence. Image tensors are NHWC."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ava256_tpu_torch.models.bottleneck import kl_loss_stable


def mean_ell_1(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def mean_ell_2(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def compute_losses(
    output: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    loss_weights: Dict[str, float],
    vertmean: torch.Tensor,
    vertstd: float,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (total, per-term scalar dict)."""
    losses: Dict[str, torch.Tensor] = {}
    if "irgbl1" in loss_weights:
        losses["irgbl1"] = mean_ell_1(output["irgbrec"], batch["image"])
    if "vertl1" in loss_weights:
        losses["vertl1"] = mean_ell_1(output["verts"], batch["verts"] * vertstd + vertmean)
    if "primvolsum" in loss_weights:
        losses["primvolsum"] = torch.mean(
            torch.sum(torch.prod(1.0 / output["primscale"], dim=-1), dim=-1))
    if "kldiv" in loss_weights:
        losses["kldiv"] = torch.mean(kl_loss_stable(output["expr_mu"], output["expr_logstd"]))
    if not losses:
        raise ValueError("No losses were computed. We can't train like that!")
    total = sum(loss_weights[k] * v for k, v in losses.items())
    return total, losses
