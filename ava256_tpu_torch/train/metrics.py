# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Image quality metrics, as ``ava256_tpu.train.metrics``: PSNR, SSIM and
LPIPS over NHWC batches (values in [0, data_range]), as plain tensor
functions on the batch's device.

Precision. SSIM's variance terms cancel (blur(x^2) - blur(x)^2 with x ~ 100),
so its blur runs in fp64. LPIPS runs in fp32 with TF32 switched off for its
convolutions (cuDNN would otherwise round their inputs to 10 bits). JAX's
"SAME" padding is not PyTorch's for stride > 1: it pads
max((ceil(n/s) - 1) * s + k - n, 0) in all, total // 2 before and the rest
after, by hand here (``-inf`` for the max-pool).
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over the whole batch."""
    mse = torch.mean((pred.float() - target.float()) ** 2)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))


def ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    data_range: float = 255.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """Mean SSIM over a batch of NHWC images (Gaussian-windowed, VALID)."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    x = pred.to(torch.float64).permute(0, 3, 1, 2)
    y = target.to(torch.float64).permute(0, 3, 1, 2)

    half = kernel_size // 2
    coords = torch.arange(kernel_size, dtype=torch.float64, device=x.device) - half
    g = torch.exp(-(coords**2) / (2.0 * sigma**2))
    g = g / g.sum()
    c = x.shape[1]
    kern_h = g.reshape(1, 1, kernel_size, 1).repeat(c, 1, 1, 1)
    kern_w = g.reshape(1, 1, 1, kernel_size).repeat(c, 1, 1, 1)

    def blur(img):
        return F.conv2d(F.conv2d(img, kern_h, groups=c), kern_w, groups=c)

    mu_x = blur(x)
    mu_y = blur(y)
    mu_x2, mu_y2, mu_xy = mu_x**2, mu_y**2, mu_x * mu_y
    sig_x = blur(x * x) - mu_x2
    sig_y = blur(y * y) - mu_y2
    sig_xy = blur(x * y) - mu_xy

    num = (2 * mu_xy + c1) * (2 * sig_xy + c2)
    den = (mu_x2 + mu_y2 + c1) * (sig_x + sig_y + c2)
    return torch.mean(num / den).float()


# ---------------------------------------------------------------------------
# LPIPS (learned perceptual image patch similarity)
# ---------------------------------------------------------------------------

_LPIPS_LAYERS = (  # AlexNet-topology feature stack: (out_ch, kernel, stride)
    (64, 11, 4),
    (192, 5, 1),
    (384, 3, 1),
    (256, 3, 1),
    (256, 3, 1),
)


@functools.lru_cache(maxsize=2)
def _lpips_filters(seed: int = 0) -> Tuple[np.ndarray, ...]:
    """Deterministic He-initialized filters [k, k, cin, cout] for the
    random-feature metric (the same draws as the JAX package's)."""
    rng = np.random.RandomState(seed)
    filters = []
    cin = 3
    for cout, k, _ in _LPIPS_LAYERS:
        w = rng.randn(k, k, cin, cout).astype(np.float32)
        w *= np.sqrt(2.0 / (k * k * cin))
        filters.append(w)
        cin = cout
    return tuple(filters)


def lpips_weights_path(weights_path: Optional[str] = None) -> Optional[str]:
    """The trained-LPIPS weights file (.npz) if one is configured and exists:
    the explicit argument wins, else the AVA256_LPIPS_WEIGHTS env var.
    Returns None when the metric falls back to random features: callers then
    report the value under the key ``lpips_rf``, never ``lpips``
    (random-feature distances are orders of magnitude smaller than trained
    AlexNet LPIPS and must not be compared with them)."""
    weights_path = weights_path or os.environ.get("AVA256_LPIPS_WEIGHTS")
    if weights_path and os.path.exists(weights_path):
        return weights_path
    return None


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    (top, bottom), (left, right) = _same_pad(x.shape[2], k, s), _same_pad(x.shape[3], k, s)
    return F.pad(x, (left, right, top, bottom), value=value)


def lpips(
    pred: torch.Tensor,
    target: torch.Tensor,
    data_range: float = 255.0,
    weights_path: Optional[str] = None,
    seed: int = 0,
) -> torch.Tensor:
    """LPIPS distance over a batch of NHWC images (lower is better).

    The standard recipe (Zhang et al. 2018): a conv feature stack,
    channel-unit-normalized features per layer, squared differences averaged
    spatially and summed over layers. With ``weights_path`` (or the
    AVA256_LPIPS_WEIGHTS env var) naming an .npz with ``conv0..conv4``
    [k, k, cin, cout] and optional ``lin0..lin4`` [cout], those trained
    filters are used; otherwise deterministic He-initialized random features
    (fixed seed): comparable across runs of this code base, not with other
    stacks' LPIPS.
    """
    weights_path = lpips_weights_path(weights_path)
    lins: List[Optional[np.ndarray]] = [None] * len(_LPIPS_LAYERS)
    if weights_path:
        data = np.load(weights_path)
        filters = [np.asarray(data[f"conv{i}"], np.float32) for i in range(5)]
        lins = [np.asarray(data[f"lin{i}"], np.float32) if f"lin{i}" in data else None
                for i in range(5)]
    else:
        filters = _lpips_filters(seed)
    dev = pred.device
    weights = [torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).to(dev)
               for w in filters]  # HWIO -> OIHW

    # scale to [-1, 1] like the reference implementation's input convention
    x = (pred.float() / data_range * 2.0 - 1.0).permute(0, 3, 1, 2)
    y = (target.float() / data_range * 2.0 - 1.0).permute(0, 3, 1, 2)

    def features(img):
        feats = []
        h = img
        for w, (_, k, stride) in zip(weights, _LPIPS_LAYERS):
            h = F.relu(F.conv2d(_pad_same(h, k, stride), w, stride=stride))
            feats.append(h)
            if len(feats) in (1, 2):  # pool between early stages
                h = F.max_pool2d(_pad_same(h, 3, 2, value=-float("inf")), 3, 2)
        return feats

    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, allow_tf32=False):
        fx = features(x)
        fy = features(y)
    total = torch.zeros((), device=dev)
    for i, (a, b) in enumerate(zip(fx, fy)):
        a = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-10)
        b = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=1e-10)
        d = (a - b) ** 2
        if lins[i] is not None:
            d = d * torch.from_numpy(lins[i]).to(dev)[None, :, None, None]
            total = total + torch.mean(torch.sum(d, dim=1))
        else:
            # uncalibrated variant: uniform channel average per layer
            total = total + torch.mean(d)
    return total
