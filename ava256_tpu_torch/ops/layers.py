# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Weight-normalized layers (PyTorch, NCHW inside the modules).

Same semantics as ``ava256_tpu.ops.layers``:

- the effective weight is ``w * g[oc] / ||w||_F``, the Frobenius norm taken
  over the whole weight tensor, ``g`` initialized to ``||w_init||_F``;
- Xavier-uniform init with an explicit gain; transposed convs divide the
  kernel fan by the stride and start parity-constant across the stride
  lattice (no checkerboard at init).

Weights use PyTorch layouts: ``[out, in]`` for dense layers, OIHW for convs
and ``[in, out, kh, kw]`` for transposed convs. ``convert.py`` maps the JAX
package's HWIO / ``[in, out]`` trees onto them. The modules take NCHW; the
model modules keep NHWC at their public boundary and permute once inside.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

# torch.nn.init.calculate_gain("leaky_relu", 0.2)
LEAKY_GAIN = math.sqrt(2.0 / (1.0 + 0.2 * 0.2))


REMAT = True  # switch for the tests: False keeps every activation


def remat(fn, *args):
    """Activation checkpointing where the JAX package uses ``nn.remat`` or
    ``jax.checkpoint``: ``fn``'s activations are dropped after the forward and
    recomputed in the backward. Active only while gradients are recorded;
    values and gradients are the same with and without."""
    if REMAT and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 preserve_rng_state=False)
    return fn(*args)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def _as_pair(v: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _xavier_bound(gain: float, fan_in: int, fan_out: int, ksize: int) -> float:
    """a of Uniform(-a, a) = gain * sqrt(2 / ((n1 + n2) * ksize)) * sqrt(3)."""
    return gain * math.sqrt(2.0 / ((fan_in + fan_out) * ksize)) * math.sqrt(3.0)


def _uniform(shape, a: float) -> torch.Tensor:
    return torch.empty(shape).uniform_(-a, a)


class _WeightNorm(nn.Module):
    """Holds ``weight``, ``g`` (per output channel) and an optional ``bias``."""

    channel_axis = 0

    def _init_params(self, weight: torch.Tensor, out_features: int, bias: bool):
        self.weight = nn.Parameter(weight)
        self.g = nn.Parameter(torch.sqrt(torch.sum(weight**2)) * torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def effective_weight(self) -> torch.Tensor:
        wnorm = torch.sqrt(torch.sum(self.weight**2))
        shape = [1] * self.weight.ndim
        shape[self.channel_axis] = -1
        return self.weight * (self.g / wnorm).reshape(shape)


class LinearWN(_WeightNorm):
    """Weight-normalized dense layer. Input [..., in] -> [..., out]."""

    def __init__(self, in_features: int, out_features: int, gain: float = 1.0,
                 bias: bool = True):
        super().__init__()
        a = _xavier_bound(gain, in_features, out_features, 1)
        self._init_params(_uniform((out_features, in_features), a), out_features, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.effective_weight(), self.bias)


class Conv2dWN(_WeightNorm):
    """Weight-normalized 2D conv, NCHW, OIHW weight."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_size: Union[int, Tuple[int, int]] = 1,
                 strides: Union[int, Tuple[int, int]] = 1,
                 padding: Union[int, Tuple[int, int]] = 0,
                 gain: float = 1.0, bias: bool = True):
        super().__init__()
        kh, kw = _as_pair(kernel_size)
        self.stride = _as_pair(strides)
        self.padding = _as_pair(padding)
        a = _xavier_bound(gain, in_features, out_features, kh * kw)
        self._init_params(_uniform((out_features, in_features, kh, kw), a),
                          out_features, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.effective_weight(), self.bias, self.stride, self.padding)


class ConvTranspose2dWN(_WeightNorm):
    """Weight-normalized 2D transposed conv, NCHW, weight [in, out, kh, kw].
    Output size ``(in - 1) * stride - 2 * padding + kernel_size``."""

    channel_axis = 1

    def __init__(self, in_features: int, out_features: int,
                 kernel_size: Union[int, Tuple[int, int]] = 4,
                 strides: Union[int, Tuple[int, int]] = 2,
                 padding: Union[int, Tuple[int, int]] = 1,
                 gain: float = 1.0, bias: bool = True):
        super().__init__()
        kh, kw = _as_pair(kernel_size)
        sh, sw = self.stride = _as_pair(strides)
        self.padding = _as_pair(padding)
        a = _xavier_bound(gain, in_features, out_features, (kh * kw) // (sh * sw))
        if kh % sh == 0 and kw % sw == 0 and sh > 1 and sw > 1:
            # blockwise init: one base value per stride-parity block
            base = _uniform((in_features, out_features, kh // sh, kw // sw), a)
            w = base.repeat_interleave(sh, dim=2).repeat_interleave(sw, dim=3)
        else:
            w = _uniform((in_features, out_features, kh, kw), a)
        self._init_params(w, out_features, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.effective_weight(), self.bias, self.stride,
                                  self.padding)


class Linear(nn.Module):
    """Plain dense layer with the Xavier-uniform init (no weight norm)."""

    def __init__(self, in_features: int, out_features: int, gain: float = 1.0,
                 bias: bool = True):
        super().__init__()
        a = _xavier_bound(gain, in_features, out_features, 1)
        self.weight = nn.Parameter(_uniform((out_features, in_features), a))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Conv2d(nn.Module):
    """Plain 2D conv (NCHW, OIHW) with the Xavier-uniform init (no weight norm)."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_size: Union[int, Tuple[int, int]] = 1,
                 strides: Union[int, Tuple[int, int]] = 1,
                 padding: Union[int, Tuple[int, int]] = 0,
                 gain: float = 1.0, bias: bool = True):
        super().__init__()
        kh, kw = _as_pair(kernel_size)
        self.stride = _as_pair(strides)
        self.padding = _as_pair(padding)
        a = _xavier_bound(gain, in_features, out_features, kh * kw)
        self.weight = nn.Parameter(_uniform((out_features, in_features, kh, kw), a))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class ConvSeq(nn.Module):
    """A stack of (conv, leaky-relu) pairs: every layer followed by an
    activation gets the leaky-relu gain, a final layer without one gain 1.
    Layers are named like the JAX package's auto-named submodules
    (``Conv2dWN_0``, ``ConvTranspose2dWN_0``, ...) so weights convert by path.

    specs: dicts with keys features/kernel_size/strides/padding and optional
    "transpose": True.
    """

    def __init__(self, in_features: int, specs: Sequence[dict],
                 final_activation: bool = False):
        super().__init__()
        self.acts = []
        self.names = []
        counts = {"Conv2dWN": 0, "ConvTranspose2dWN": 0}
        ch = in_features
        for i, spec in enumerate(specs):
            act = i < len(specs) - 1 or final_activation
            cls = ConvTranspose2dWN if spec.get("transpose") else Conv2dWN
            name = f"{cls.__name__}_{counts[cls.__name__]}"
            counts[cls.__name__] += 1
            kwargs = {k: v for k, v in spec.items() if k not in ("transpose", "features")}
            setattr(self, name, cls(ch, spec["features"], gain=LEAKY_GAIN if act else 1.0,
                                    **kwargs))
            self.names.append(name)
            self.acts.append(act)
            ch = spec["features"]
        self.out_features = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name, act in zip(self.names, self.acts):
            x = getattr(self, name)(x)
            if act:
                x = leaky_relu(x)
        return x


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


__all__ = [
    "LEAKY_GAIN", "leaky_relu", "LinearWN", "Conv2dWN", "ConvTranspose2dWN",
    "Linear", "Conv2d", "ConvSeq", "nhwc_to_nchw", "nchw_to_nhwc",
]
