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

``dtype`` (None or ``torch.bfloat16``) is the compute dtype, as the JAX
layers' flax ``dtype``: parameters stay float32; the input is cast to
``dtype``, the effective weight is cast after its float32 norm, the product
or convolution runs and is rounded in ``dtype``, and only then is the bias,
cast to ``dtype``, added (two roundings, as JAX's; fused into the op it
would be one). In float32 the bias stays fused into the op.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence, Tuple, Union

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


@functools.lru_cache(maxsize=None)
def _rounded(c: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(c, dtype=dtype))


def weak(c: float, x: torch.Tensor) -> float:
    """The Python scalar ``c`` as JAX applies it to ``x``: a weakly typed
    constant takes x's dtype first, so against bfloat16 it is rounded to
    bfloat16 (PyTorch would compute with the unrounded value)."""
    return c if x.element_size() >= 4 else _rounded(float(c), x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, weak(negative_slope, x) * x)


def _affine(x: torch.Tensor, dtype: Optional[torch.dtype], weight: torch.Tensor,
            bias: Optional[torch.Tensor], op: Callable, bias_shape=(-1,)) -> torch.Tensor:
    """``op(x, weight, bias)`` at JAX's rounding points for ``dtype``; the
    bias is viewed as ``bias_shape`` against op's output."""
    if dtype is not None:
        x = x.to(dtype)
    if x.dtype == weight.dtype:
        return op(x, weight, bias)
    y = op(x, weight.to(x.dtype), None)
    return y if bias is None else y + bias.to(x.dtype).reshape(bias_shape)


def _as_pair(v: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _xavier_bound(gain: float, fan_in: int, fan_out: int, ksize: int) -> float:
    """a of Uniform(-a, a) = gain * sqrt(2 / ((n1 + n2) * ksize)) * sqrt(3)."""
    return gain * math.sqrt(2.0 / ((fan_in + fan_out) * ksize)) * math.sqrt(3.0)


def _uniform(shape, a: float) -> torch.Tensor:
    return torch.empty(shape).uniform_(-a, a)


class _WeightNorm(nn.Module):
    """Holds ``weight``, ``g`` (per output channel) and an optional ``bias``;
    ``g`` is None once ``fuse()`` has folded it into the weight."""

    channel_axis = 0

    def _init_params(self, weight: torch.Tensor, out_features: int, bias: bool,
                     dtype: Optional[torch.dtype]):
        self.dtype = dtype
        self.weight = nn.Parameter(weight)
        self.g = nn.Parameter(torch.sqrt(torch.sum(weight**2)) * torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def effective_weight(self) -> torch.Tensor:
        if self.g is None:  # fused
            return self.weight
        wnorm = torch.sqrt(torch.sum(self.weight**2))
        shape = [1] * self.weight.ndim
        shape[self.channel_axis] = -1
        return self.weight * (self.g / wnorm).reshape(shape)

    def fuse(self) -> None:
        """Fold ``g / ||weight||`` into the weight and drop ``g``."""
        with torch.no_grad():
            self.weight.copy_(self.effective_weight())
        self.g = None


class LinearWN(_WeightNorm):
    """Weight-normalized dense layer. Input [..., in] -> [..., out]."""

    def __init__(self, in_features: int, out_features: int, gain: float = 1.0,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        a = _xavier_bound(gain, in_features, out_features, 1)
        self._init_params(_uniform((out_features, in_features), a), out_features, bias, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _affine(x, self.dtype, self.effective_weight(), self.bias, F.linear)


class Conv2dWN(_WeightNorm):
    """Weight-normalized 2D conv, NCHW, OIHW weight."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_size: Union[int, Tuple[int, int]] = 1,
                 strides: Union[int, Tuple[int, int]] = 1,
                 padding: Union[int, Tuple[int, int]] = 0,
                 gain: float = 1.0, bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        kh, kw = _as_pair(kernel_size)
        self.stride = _as_pair(strides)
        self.padding = _as_pair(padding)
        a = _xavier_bound(gain, in_features, out_features, kh * kw)
        self._init_params(_uniform((out_features, in_features, kh, kw), a),
                          out_features, bias, dtype)

    def _op(self, x, w, b):
        return F.conv2d(x, w, b, self.stride, self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _affine(x, self.dtype, self.effective_weight(), self.bias, self._op, (-1, 1, 1))


@functools.lru_cache(maxsize=None)
def _phase_taps(stride: int, taps: int, device: torch.device) -> torch.Tensor:
    """[stride, taps] kernel indices: output row y is phase r = (y + p) % stride
    at q = (y + p) // stride, made of input rows q - j (row q of the input
    padded by taps - 1) with kernel tap r + stride * j; listed for t = taps -
    1 - j, the correlation's order. Cached: built once per device, outside
    any inference mode (autograd saves it for the weight's gradient)."""
    with torch.inference_mode(False):
        return torch.tensor([[r + stride * (taps - 1 - t) for t in range(taps)]
                             for r in range(stride)], device=device)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                     stride: Tuple[int, int], padding: Tuple[int, int]) -> torch.Tensor:
    """``F.conv_transpose2d`` (weight [in, out, kh, kw]); on a CUDA tensor with
    a kernel that is a multiple of the stride, in its sub-pixel form
    (``conv_transpose2d_subpixel``): cuDNN's deterministic algorithm for a
    transposed convolution (its data gradient) was the largest cost of a
    deterministic training step on the flagship's decoders (H100), while an
    ordinary convolution's forward is deterministic and fast. On the CPU ``F.conv_transpose2d``
    stays: its weight gradient over a batch equals the sum of its items'
    (the sub-pixel form's differs in the last bits), which the CPU test of
    data-parallel ranks against one process holds it to
    (tests/test_torch_port_parallel.py; Adam turns last-bit differences of
    near-zero gradients into whole steps)."""
    kh, kw = w.shape[2:]
    if not x.is_cuda or kh % stride[0] or kw % stride[1] or stride[0] * stride[1] == 1:
        return F.conv_transpose2d(x, w, b, stride, padding)
    return conv_transpose2d_subpixel(x, w, b, stride, padding)


def conv_transpose2d_subpixel(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                              stride: Tuple[int, int],
                              padding: Tuple[int, int]) -> torch.Tensor:
    """``F.conv_transpose2d`` for a kernel that is a multiple of the stride:
    output phase (ry, rx) of the stride^2 is an ordinary convolution of the
    input with every stride-th tap of the flipped kernel, so all phases are
    one convolution with stride^2 x out channels, then interleaved. The same
    products and sums, in another order."""
    (sh, sw), (ph, pw) = stride, padding
    cin, cout, kh, kw = w.shape
    th, tw = kh // sh, kw // sw
    hin, win = x.shape[2:]
    iy, ix = _phase_taps(sh, th, w.device), _phase_taps(sw, tw, w.device)
    taps = w[:, :, iy[:, None, :, None], ix[None, :, None, :]]  # [in, out, sh, sw, th, tw]
    taps = taps.permute(2, 3, 1, 0, 4, 5).reshape(sh * sw * cout, cin, th, tw)
    y = F.conv2d(F.pad(x, (tw - 1, tw - 1, th - 1, th - 1)), taps,
                 None if b is None else b.repeat(sh * sw))
    n, _, qh, qw = y.shape
    y = y.reshape(n, sh, sw, cout, qh, qw).permute(0, 3, 4, 1, 5, 2)
    y = y.reshape(n, cout, qh * sh, qw * sw)
    hout = (hin - 1) * sh - 2 * ph + kh
    wout = (win - 1) * sw - 2 * pw + kw
    return y[:, :, ph:ph + hout, pw:pw + wout]


class ConvTranspose2dWN(_WeightNorm):
    """Weight-normalized 2D transposed conv, NCHW, weight [in, out, kh, kw].
    Output size ``(in - 1) * stride - 2 * padding + kernel_size``."""

    channel_axis = 1

    def __init__(self, in_features: int, out_features: int,
                 kernel_size: Union[int, Tuple[int, int]] = 4,
                 strides: Union[int, Tuple[int, int]] = 2,
                 padding: Union[int, Tuple[int, int]] = 1,
                 gain: float = 1.0, bias: bool = True, dtype: Optional[torch.dtype] = None):
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
        self._init_params(w, out_features, bias, dtype)

    def _op(self, x, w, b):
        return conv_transpose2d(x, w, b, self.stride, self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _affine(x, self.dtype, self.effective_weight(), self.bias, self._op, (-1, 1, 1))


class Linear(nn.Module):
    """Plain dense layer with the Xavier-uniform init (no weight norm)."""

    def __init__(self, in_features: int, out_features: int, gain: float = 1.0,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        a = _xavier_bound(gain, in_features, out_features, 1)
        self.dtype = dtype
        self.weight = nn.Parameter(_uniform((out_features, in_features), a))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _affine(x, self.dtype, self.weight, self.bias, F.linear)


class Conv2d(nn.Module):
    """Plain 2D conv (NCHW, OIHW) with the Xavier-uniform init (no weight norm)."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_size: Union[int, Tuple[int, int]] = 1,
                 strides: Union[int, Tuple[int, int]] = 1,
                 padding: Union[int, Tuple[int, int]] = 0,
                 gain: float = 1.0, bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        kh, kw = _as_pair(kernel_size)
        self.stride = _as_pair(strides)
        self.padding = _as_pair(padding)
        a = _xavier_bound(gain, in_features, out_features, kh * kw)
        self.dtype = dtype
        self.weight = nn.Parameter(_uniform((out_features, in_features, kh, kw), a))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def _op(self, x, w, b):
        return F.conv2d(x, w, b, self.stride, self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _affine(x, self.dtype, self.weight, self.bias, self._op, (-1, 1, 1))


class ConvSeq(nn.Module):
    """A stack of (conv, leaky-relu) pairs: every layer followed by an
    activation gets the leaky-relu gain, a final layer without one gain 1.
    Layers are named like the JAX package's auto-named submodules
    (``Conv2dWN_0``, ``ConvTranspose2dWN_0``, ...) so weights convert by path.

    specs: dicts with keys features/kernel_size/strides/padding and optional
    "transpose": True.
    """

    def __init__(self, in_features: int, specs: Sequence[dict],
                 final_activation: bool = False, dtype: Optional[torch.dtype] = None):
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
                                    dtype=dtype, **kwargs))
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
    "LEAKY_GAIN", "weak", "leaky_relu", "LinearWN", "Conv2dWN", "ConvTranspose2dWN",
    "Linear", "Conv2d", "ConvSeq", "nhwc_to_nchw", "nchw_to_nhwc",
]
