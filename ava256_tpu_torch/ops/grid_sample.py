# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""2D grid sampling and bilinear resize with NHWC at the interface.

- ``grid_sample_2d`` is ``F.grid_sample(mode="bilinear",
  padding_mode="zeros")``, the semantics ``ava256_tpu.ops.grid_sample``
  reimplements (its packed neighbourhood form is a TPU gather trick). It
  goes through ``GridSample``, a ``torch.autograd.Function``: on CUDA tensors
  the hand-written kernels of ``csrc/grid_sample.cu`` (forward, and a
  backward whose image gradient is an integer sum at a fixed-point scale, so
  it has the same bits on every run; PyTorch's own backward adds with float
  atomics and has no deterministic form), on CPU tensors their plain
  version, ``F.grid_sample`` and its backward. Float32 only: a bfloat16 image
  sampled on a float32 grid is promoted first, as JAX multiplies the
  bfloat16 corners by float32 weights.
- ``resize_bilinear`` is half-pixel-centre bilinear resampling without
  antialiasing (``jax.image.resize(..., "bilinear", antialias=False)``); at
  the border the JAX kernel renormalizes its weights, which is the same as
  ``F.interpolate``'s clamp of the source coordinate.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ava256_tpu_torch.ops import fixed_point
from ava256_tpu_torch.ops.cuda_lib import CudaLib

GRID_SAMPLE_LIB = CudaLib("grid_sample.cu")


def _check(img: torch.Tensor, grid: torch.Tensor) -> None:
    """What the kernels (and so the Function) take: float32 img [N, H, W, C]
    and grid [N, Ho, Wo, 2] on one device."""
    for name, x in (("img", img), ("grid", grid)):
        if x.dtype != torch.float32:
            raise ValueError(f"grid_sample: {name} must be float32 (the kernels sample in "
                             f"float32; promote a bfloat16 image first), got {x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"grid_sample: {name} must be 4-D, got {tuple(x.shape)}")
    if grid.shape[0] != img.shape[0] or grid.shape[3] != 2:
        raise ValueError(f"grid_sample: grid must be [N, Ho, Wo, 2] with img's N, got "
                         f"{tuple(grid.shape)} for img {tuple(img.shape)}")
    if grid.device != img.device:
        raise ValueError(f"grid_sample: img on {img.device}, grid on {grid.device}")


def grid_sample_plain(img: torch.Tensor, grid: torch.Tensor,
                      align_corners: bool = False) -> torch.Tensor:
    """The plain version: ``F.grid_sample`` with NHWC at the interface."""
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode="zeros",
                        align_corners=align_corners)
    return out.permute(0, 2, 3, 1)


def grid_sample_bwd_plain(img, grid, gout, align_corners=False, need_img=True,
                          need_grid=True) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``F.grid_sample``'s own backward, NHWC: (d img or None, d grid or None)."""
    gi, gg = torch.ops.aten.grid_sampler_2d_backward(
        gout.permute(0, 3, 1, 2), img.permute(0, 3, 1, 2), grid, 0, 0, align_corners,
        [need_img, need_grid])
    return (gi.permute(0, 2, 3, 1) if need_img else None), (gg if need_grid else None)


class _GridSampleKernels:
    """Wrapper of the forward and backward kernels of ``csrc/grid_sample.cu``
    with their launch counts."""

    def __init__(self, cuda_lib: CudaLib):
        self.cuda_lib = cuda_lib
        self.launches = 0  # forward kernel
        self.bwd_launches = 0

    def _lib(self) -> ctypes.CDLL:
        lib = self.cuda_lib.lib()
        lib.grid_sample_fwd.restype = ctypes.c_int
        lib.grid_sample_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        lib.grid_sample_bwd.restype = ctypes.c_int
        lib.grid_sample_bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        return lib

    @staticmethod
    def _dims(img, grid):
        n, h, w, c = img.shape
        return n, h, w, c, grid.shape[1], grid.shape[2]

    def forward(self, img: torch.Tensor, grid: torch.Tensor, align_corners: bool = False):
        _check(img, grid)
        img, grid = img.contiguous(), grid.contiguous()
        n, h, w, c, ho, wo = self._dims(img, grid)
        out = torch.empty((n, ho, wo, c), dtype=torch.float32, device=img.device)
        lib = self._lib()
        stream = torch.cuda.current_stream(img.device).cuda_stream
        with torch.cuda.device(img.device):
            err = lib.grid_sample_fwd(img.data_ptr(), grid.data_ptr(), out.data_ptr(), n, h, w,
                                      c, ho, wo, int(align_corners), stream)
        self.cuda_lib.check(err, "grid_sample_fwd launch")
        self.launches += 1
        return out

    def backward(self, img, grid, gout, align_corners=False, need_img=True, need_grid=True):
        """(d img or None, d grid or None). The image gradient's scale is
        2^floor(61 - log2 sum|gout|): a pixel's four weights sum to 1, so no
        sum can leave int64."""
        _check(img, grid)
        img, grid = img.contiguous(), grid.contiguous()
        gout = gout.to(torch.float32).contiguous()
        n, h, w, c, ho, wo = self._dims(img, grid)
        if gout.shape != (n, ho, wo, c):
            raise ValueError(f"grid_sample: gout must be {(n, ho, wo, c)}, got "
                             f"{tuple(gout.shape)}")
        dev = img.device
        q = gimg = scale = inv = None
        if need_img:
            scale = fixed_point.scale_for(gout.abs().sum(dtype=torch.float64)).reshape(1)
            inv = 1.0 / scale
            q = torch.zeros(img.shape, dtype=torch.int64, device=dev)
            gimg = torch.empty_like(img)
        ggrid = torch.empty_like(grid) if need_grid else None
        ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
        lib = self._lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = lib.grid_sample_bwd(
                img.data_ptr(), grid.data_ptr(), gout.data_ptr(), ptr(q), ptr(scale), ptr(inv),
                ptr(gimg), ptr(ggrid), fixed_point.flag(dev).data_ptr(), n, h, w, c, ho, wo,
                int(align_corners), stream)
        self.cuda_lib.check(err, "grid_sample_bwd launch")
        self.bwd_launches += 1
        return gimg, ggrid


grid_sample_kernels = _GridSampleKernels(GRID_SAMPLE_LIB)


def _route(x: torch.Tensor) -> bool:
    """True for the kernels (CUDA tensors), False for the plain version."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"no grid_sample for tensors on {x.device}")
    return False


class GridSample(torch.autograd.Function):
    """``grid_sample_2d`` on float32 NHWC tensors, differentiable in img and
    grid: the kernels on CUDA tensors, ``F.grid_sample`` on CPU tensors."""

    @staticmethod
    def forward(ctx, img, grid, align_corners=False):
        _check(img, grid)
        ctx.save_for_backward(img, grid)
        ctx.align_corners = bool(align_corners)
        if _route(img):
            return grid_sample_kernels.forward(img, grid, align_corners)
        return grid_sample_plain(img, grid, align_corners)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        img, grid = ctx.saved_tensors
        need_img, need_grid = ctx.needs_input_grad[:2]
        if not (need_img or need_grid):
            return None, None, None
        bwd = grid_sample_kernels.backward if _route(img) else grid_sample_bwd_plain
        gimg, ggrid = bwd(img, grid, gout, ctx.align_corners, need_img, need_grid)
        return gimg, ggrid, None


def grid_sample_2d(img: torch.Tensor, grid: torch.Tensor,
                   align_corners: bool = False) -> torch.Tensor:
    """img [N, H, W, C], grid [N, Ho, Wo, 2] with (x, y) in [-1, 1]
    -> [N, Ho, Wo, C], in the promoted dtype of img and grid, which must be
    float32 (``GridSample`` refuses any other)."""
    dtype = torch.promote_types(img.dtype, grid.dtype)
    return GridSample.apply(img.to(dtype), grid.to(dtype), align_corners)


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """img [N, H, W, C] -> [N, out_hw[0], out_hw[1], C]."""
    out = F.interpolate(img.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                        align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1)
