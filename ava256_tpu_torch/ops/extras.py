# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Auxiliary layers, the port of ``ava256_tpu.ops.extras``: binomial-blur
downsampling, mask dilation, a coordinate-conditioned conv, the NFNet
weight-standardized conv and weight-norm fusing for inference. Tensors are
NHWC at the public boundary, as the model modules take them; weights are in
PyTorch's layouts (``convert.py`` maps the JAX trees onto them).
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ava256_tpu_torch.ops.layers import Conv2d, _as_pair, _WeightNorm, nchw_to_nhwc, nhwc_to_nchw

_BINOMIAL = np.array([1.0, 6.0, 15.0, 20.0, 15.0, 6.0, 1.0], np.float32)


def _depthwise(x: torch.Tensor, k: np.ndarray, stride: int, padding: int) -> torch.Tensor:
    """The 2D filter k on every channel of x [N, C, H, W]."""
    c = x.shape[1]
    kernel = torch.as_tensor(np.ascontiguousarray(k), dtype=x.dtype, device=x.device)
    kernel = kernel[None, None].expand(c, 1, *k.shape)
    return F.conv2d(x, kernel, stride=stride, padding=padding, groups=c)


def downsample2d(x: torch.Tensor, stride: int = 1,
                 padding: Union[int, str] = 0) -> torch.Tensor:
    """Depthwise 7x7 binomial blur (and an optional stride), NHWC.
    ``padding="reflect"`` pads 3 by reflection, an int pads with zeros."""
    k = _BINOMIAL[:, None] * _BINOMIAL[None, :]
    k = k / k.sum()
    x = nhwc_to_nchw(x)
    if padding == "reflect":
        x, padding = F.pad(x, (3, 3, 3, 3), mode="reflect"), 0
    return nchw_to_nhwc(_depthwise(x, k, stride, padding))


def dilate2d(x: torch.Tensor, kernel_size: int, stride: int = 1,
             padding: int = 0) -> torch.Tensor:
    """Depthwise box filter clamped at 1 (mask dilation), NHWC."""
    k = np.ones((kernel_size, kernel_size), np.float32)
    k /= k.sum()
    out = _depthwise(nhwc_to_nchw(x), k, stride, padding)
    return nchw_to_nhwc(torch.clamp(out, max=1.0))


class CoordConv2d(nn.Module):
    """A conv over the input with normalized (y, x) coordinate channels
    appended, NHWC. The conv is ``Conv2d_0``, as the JAX module names it."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Union[int, Tuple[int, int]] = 1,
                 strides: Union[int, Tuple[int, int]] = 1,
                 padding: Union[int, Tuple[int, int]] = 0):
        super().__init__()
        self.Conv2d_0 = Conv2d(in_features + 2, features, kernel_size, strides, padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = x.shape
        ys = torch.linspace(-1.0, 1.0, h, dtype=x.dtype, device=x.device)
        xs = torch.linspace(-1.0, 1.0, w, dtype=x.dtype, device=x.device)
        x = torch.cat([x, ys[None, :, None, None].expand(n, h, w, 1),
                       xs[None, None, :, None].expand(n, h, w, 1)], dim=-1)
        return nchw_to_nhwc(self.Conv2d_0(nhwc_to_nchw(x)))


class Conv2dWS(nn.Module):
    """Weight-standardized conv (NFNet), NHWC: each output channel's kernel
    standardized over (in, kh, kw), scaled by 1.414 / sqrt(max(var * fan_in,
    eps)) and a learned gain. ``weight`` is OIHW, He-normal at init."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Union[int, Tuple[int, int]] = 3,
                 strides: Union[int, Tuple[int, int]] = 1,
                 padding: Union[int, Tuple[int, int]] = 0, eps: float = 1e-4):
        super().__init__()
        kh, kw = _as_pair(kernel_size)
        self.stride = _as_pair(strides)
        self.padding = _as_pair(padding)
        self.eps = eps
        self.fan_in = kh * kw * in_features
        # flax's he_normal: a normal truncated at 2 sigma, rescaled to the
        # variance 2 / fan_in
        std = math.sqrt(2.0 / self.fan_in) / 0.87962566103423978
        w = torch.empty((features, in_features, kh, kw))
        self.weight = nn.Parameter(nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std))
        self.gain = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        mean = torch.mean(w, dim=(1, 2, 3), keepdim=True)
        var = torch.var(w, dim=(1, 2, 3), unbiased=False, keepdim=True)
        scale = 1.414 * torch.rsqrt(torch.clamp(var * self.fan_in, min=self.eps)) \
            * self.gain[:, None, None, None]
        y = F.conv2d(nhwc_to_nchw(x), (w - mean) * scale, self.bias, self.stride, self.padding)
        return nchw_to_nhwc(y)


def fuse_weightnorm(module: nn.Module) -> nn.Module:
    """Fold the weight-norm scales into the kernels for inference, in place,
    as the reference layers' ``fuse()``: in every weight-normalized layer of
    ``module`` the weight becomes ``weight * g / ||weight||_F`` (per output
    channel, the norm over the whole tensor) and ``g`` is removed. Outputs
    stay the same; the state dict loses its ``g`` entries. Returns module."""
    for m in module.modules():
        if isinstance(m, _WeightNorm) and m.g is not None:
            m.fuse()
    return module
