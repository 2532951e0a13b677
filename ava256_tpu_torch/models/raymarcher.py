# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Raymarcher front end, as in ``ava256_tpu.models.raymarcher``: the step
size is ``dt / volradius`` and the output is split into rgb and alpha.

Backends:
- "reference": the PyTorch oracle (``ops.raymarch_ref``), O(K) per step,
  for tests and tiny scenes;
- "cuda": ``ops.raymarch_cuda`` — the hand-written kernels on CUDA tensors,
  their plain PyTorch versions on CPU tensors.

Both are differentiable in the decoder's outputs (primpos, primrot,
primscale, template, warp): the oracle by plain autograd, the "cuda" backend
through its backward kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ava256_tpu_torch.ops.raymarch_cuda import mvp_raymarch_cuda
from ava256_tpu_torch.ops.raymarch_ref import mvp_raymarch_reference


class Raymarcher:
    def __init__(self, volradius: float, dt: float = 1.0, backend: str = "cuda",
                 fadescale: float = 8.0, fadeexp: float = 8.0, **options):
        if backend not in ("reference", "cuda"):
            raise ValueError(f"unknown raymarch backend: {backend}")
        self.volume_radius = volradius
        self.dt = dt / volradius
        self.backend = backend
        self.fadescale = fadescale
        self.fadeexp = fadeexp
        self.options = options

    def __call__(self, raypos: torch.Tensor, raydir: torch.Tensor, tminmax: torch.Tensor,
                 decout: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (rayrgb [N, H, W, 3], rayalpha [N, H, W, 1], rayrgba [N, H, W, 4])."""
        args = (raypos, raydir, self.dt, tminmax, decout["primpos"], decout["primrot"],
                decout["primscale"], decout["template"], decout.get("warp"))
        if self.backend == "reference":
            rayrgba = mvp_raymarch_reference(
                *args, fadescale=self.fadescale, fadeexp=self.fadeexp,
                max_steps=self.options.get("max_steps", 1024))
        else:
            rayrgba = mvp_raymarch_cuda(
                *args, prim_mask=decout.get("prim_mask"), fadescale=self.fadescale,
                fadeexp=self.fadeexp, device=raypos.device, **self.options)
        return rayrgba[..., 0:3], rayrgba[..., 3:4], rayrgba
