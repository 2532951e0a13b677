# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""VAE bottleneck over the expression code, as in
``ava256_tpu.models.bottleneck``: 1x1-conv mu/logstd heads squashed by
0.1 / 0.01, reparameterized sampling, and the stable KL form."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ava256_tpu_torch.ops.layers import Conv2dWN, nchw_to_nhwc, nhwc_to_nchw, weak


def kl_loss_stable(mu: torch.Tensor, logstd: torch.Tensor) -> torch.Tensor:
    """Stable KL(q || N(0, 1)) averaged over the last axis."""
    return torch.mean(
        -0.5 + torch.abs(logstd) + 0.5 * mu**2 + 0.5 * torch.exp(-2.0 * torch.abs(logstd)),
        dim=-1,
    )


class VAEBottleneck(nn.Module):
    def __init__(self, in_dim: int = 64, out_dim: int = 16, mean_squash: float = 0.1,
                 std_squash: float = 0.01, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mean_squash = mean_squash
        self.std_squash = std_squash
        self.mu = Conv2dWN(in_dim, out_dim, 1, dtype=dtype)
        self.logstd = Conv2dWN(in_dim, out_dim, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, deterministic: bool = False,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                noise_rows: Optional[Tuple[int, int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x [N, H, W, C] -> (z, mu, logstd), each [N, H, W, out_dim].
        ``deterministic`` gives z = mu; otherwise z = mu + exp(logstd) * noise,
        with ``noise`` given or drawn from ``generator`` in logstd's dtype. ``noise_rows`` =
        (first, total): x holds rows [first, first + N) of a global batch of
        ``total``, and the draw is the global batch's, of which these rows
        are kept."""
        xc = nhwc_to_nchw(x)
        mu = nchw_to_nhwc(self.mu(xc))
        mu = mu * weak(self.mean_squash, mu)
        logstd = nchw_to_nhwc(self.logstd(xc))
        logstd = logstd * weak(self.std_squash, logstd)
        if deterministic:
            return mu, mu, logstd
        if noise is None:
            first, total = (0, logstd.shape[0]) if noise_rows is None else noise_rows
            noise = torch.randn((total,) + tuple(logstd.shape[1:]), generator=generator,
                                dtype=logstd.dtype, device=logstd.device)
            noise = noise[first:first + logstd.shape[0]]
        return mu + torch.exp(logstd) * noise, mu, logstd
