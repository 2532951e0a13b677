# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Decode frames for rendering, as ``render.py`` of the JAX package does:
the expression comes from the batch, the identity from the target neutral
texture and vertices (the batch's own, or another subject's for cross-id
reenactment), and the bottleneck takes its mean."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ava256_tpu_torch.train.profiling import annotate

BATCH_MODEL_KEYS = (
    "camrot", "campos", "focal", "princpt", "modelmatrix",
    "avgtex", "verts", "neut_avgtex", "neut_verts", "pixelcoords",
)


@torch.inference_mode()
def decode(model: nn.Module, batch: Dict[str, torch.Tensor], target_tex: torch.Tensor,
           target_verts: torch.Tensor) -> torch.Tensor:
    """batch: the model inputs of ``BATCH_MODEL_KEYS`` plus idindex and
    camindex, as tensors on the model's device; target_tex [B, M, M, 3] and
    target_verts [B, V, 3] the identity to render. Returns irgbrec
    [B, H, W, 3]."""
    with annotate("ava:decode"):
        out = model(
            target_neut_avgtex=target_tex,
            target_neut_verts=target_verts,
            idindex=batch.get("idindex"),
            camindex=batch.get("camindex"),
            deterministic=True,
            **{k: batch[k] for k in BATCH_MODEL_KEYS},
        )
    return out["irgbrec"]
