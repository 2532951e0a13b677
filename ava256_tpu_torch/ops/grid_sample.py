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
  the hand-written kernels of ``csrc/grid_sample.cu``, on CPU tensors their
  plain version, ``F.grid_sample`` and its backward. Float32 only: a
  bfloat16 image sampled on a float32 grid is promoted first, as JAX
  multiplies the bfloat16 corners by float32 weights.
- On the card the kernels read the model's layouts in place: the image may
  be channels-last (what the convolutions give when their input is) or an
  NHWC view of channels-first planes, the grid may have batch stride 0 (one
  warp expanded over the batch), ``gout`` comes as autograd gives it. ``out`` and the image gradient are written in
  the image's memory format (channels-first planes are returned as NHWC
  views).
  Nothing is copied; a tensor whose offsets pass 32 bits raises.
- The image gradient is the exact int64 sum of the individually rounded
  addends ``rint_even(w * gout * 2^k)``, times ``2^-k``, with ``2^k`` from
  ``sum |gout|`` (``fixed_point.scale_for``): the same bits on every run and
  route. ``grid_sample_bwd_fixed_plain`` restates it in PyTorch. Its kernels
  take one of two routes: the owner route for an output of the image's size
  of at least ``OWNER_MIN_PIXELS`` pixels (the warp levels from 32^2 up),
  valid when every sample's corners lie in the windows of the tiles that
  own them (each tile's window placed at its centre sample's displacement,
  ``OWNER_RADIUS`` cells around), which the first backward kernel counts on
  the device (``escape_count_plain`` restates the count); the scatter route
  (int64 table and integer atomics) for every other call, and behind the
  owner kernel, predicated on that count, for a warp level whose count is
  not 0. ``plan`` makes every launch's numbers.
- ``resize_bilinear`` is half-pixel-centre bilinear resampling without
  antialiasing (``jax.image.resize(..., "bilinear", antialias=False)``); at
  the border the JAX kernel renormalizes its weights, which is the same as
  ``F.interpolate``'s clamp of the source coordinate.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ava256_tpu_torch.ops import fixed_point, graphs
from ava256_tpu_torch.ops.cuda_lib import CudaLib

GRID_SAMPLE_LIB = CudaLib("grid_sample.cu")

BLOCK = 256  # threads a block (kBlock)
OWNER_RADIUS = 6  # D: a tile's window of output pixels reaches D cells past the moved tile
# the owner route's least image (pixels): below it the scatter route is
# faster on the card (its blocks have no window to set up), PERF.md
OWNER_MIN_PIXELS = 32 * 32
CHUNK = 8  # the owner kernel's channel groups are multiples of CHUNK channels
TARGET_THREADS = 1 << 17  # the planner splits channels and batch until a launch has this many
MAX_BLOCKS = 132 * 8  # grid-stride launches: the scatter route and the table passes
SMEM_LIMIT = 232448  # shared memory a block may use on sm_90 (227 KB)
SUM_BLOCK_ELEMS = 4096  # gout elements a block of the scale's sum takes, at the least
MAX_SUM_BLOCKS = 1024
MAX_COUNT_BLOCKS = 4096
META_BYTES = 16  # the work buffer's head: scale, 1 / scale, count, pad

# The order of csrc/grid_sample.cu's Args.
ARG_NAMES = (
    ("nfields", "n", "h", "w", "c", "ho", "wo", "align", "shared")
    + tuple(f"{t}_{d}" for t in ("img", "grid", "gout", "out") for d in "nyxc")
    + ("fwd_packed", "fwd_cpg", "fwd_cgroups", "fwd_bpg", "fwd_bgroups", "fwd_blocks",
       "route", "radius", "tw", "th", "tiles_x", "tiles_y", "cpg", "cgroups", "bpg", "bgroups",
       "smem",
       "nsum", "sum_chunk", "ncnt")
    + tuple(f"gsz{i}" for i in range(4)) + tuple(f"gst{i}" for i in range(4))
    + ("sc_lanes", "sc_blocks", "sc_iters", "numel", "tbl_blocks", "fuse_grid", "owner_vec4"))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _p2(x: int) -> int:
    """The least power of two >= x."""
    p = 1
    while p < x:
        p *= 2
    return p


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


def _check_offsets(**tensors: torch.Tensor) -> None:
    """The kernels index in 32 bits: every element's offset must fit."""
    for name, x in tensors.items():
        span = sum((s - 1) * st for s, st in zip(x.shape, x.stride()) if s > 0)
        if span >= 2**31 or x.numel() >= 2**31 or min(x.stride(), default=0) < 0:
            raise ValueError(f"grid_sample: {name} {tuple(x.shape)} with strides "
                             f"{x.stride()} has offsets past 32 bits, which the kernels "
                             f"do not take")


def channels_first(img: torch.Tensor) -> bool:
    """The image's memory format, which out and the image gradient take:
    channels-first planes unless its channels are adjacent (packed)."""
    return img.shape[3] == 1 or img.stride(3) != 1


def _empty_nhwc(n: int, h: int, w: int, c: int, planar: bool, dev) -> torch.Tensor:
    if planar:
        return torch.empty((n, c, h, w), dtype=torch.float32, device=dev).permute(0, 2, 3, 1)
    return torch.empty((n, h, w, c), dtype=torch.float32, device=dev)


def forward_plan(n: int, ho: int, wo: int, c: int, shared: bool, packed4: bool) -> dict:
    """The forward's launch: fwd_packed4 over (pixel, channel quad), or
    fwd_pixels over output pixels, with channel groups (blockIdx.y) and batch
    groups (blockIdx.z) until the launch has TARGET_THREADS threads."""
    if packed4:
        return dict(fwd_packed=1, fwd_cpg=c, fwd_cgroups=1, fwd_bpg=n, fwd_bgroups=1,
                    fwd_blocks=_cdiv(n * ho * wo * (c // 4), BLOCK))
    npix = ho * wo
    bpg = n if shared else 1
    if shared and npix * _cdiv(n, bpg) < TARGET_THREADS:
        bpg = 1
    cgroups = 1
    while npix * _cdiv(n, bpg) * cgroups < TARGET_THREADS and cgroups < c:
        cgroups *= 2
    cpg = _cdiv(c, cgroups)
    return dict(fwd_packed=0, fwd_cpg=cpg, fwd_cgroups=_cdiv(c, cpg), fwd_bpg=bpg,
                fwd_bgroups=_cdiv(n, bpg), fwd_blocks=_cdiv(npix, BLOCK))


def owner_plan(n: int, h: int, w: int, c: int, shared: bool,
               radius: int = OWNER_RADIUS) -> dict:
    """The owner kernel's launch: tiles of tw x th <= 256 cells, one block of
    BLOCK threads each, the batch looped inside a block for a shared grid
    where a cell has little work (C N <= 16) and enough threads remain, then channel
    groups (blockIdx.y, multiples of CHUNK) until it does; the grid gradient
    is fused when a block holds every channel; ``smem`` its dynamic shared
    memory (the window's weights, offsets and corners, each cell's run of
    the pairs that read it)."""
    tw = min(32, _p2(w))
    th = min(BLOCK // tw, _p2(h))
    tiles = _cdiv(w, tw) * _cdiv(h, th)
    # a block loops over the batch of a shared grid only where that is little
    # work a cell (C N <= 16: measured faster at 1024^2 x 3, slower at 512^2 x 16)
    bpg = n if shared and c * n <= 16 and tiles * BLOCK >= TARGET_THREADS else 1
    cgroups = 1
    while tiles * BLOCK * _cdiv(n, bpg) * cgroups < TARGET_THREADS and cgroups * CHUNK < c:
        cgroups *= 2
    cpg = CHUNK * _cdiv(_cdiv(c, cgroups), CHUNK)
    hn = (tw + 2 * radius) * (th + 2 * radius)
    return dict(radius=radius, tw=tw, th=th, tiles_x=_cdiv(w, tw), tiles_y=_cdiv(h, th),
                cpg=cpg, cgroups=_cdiv(c, cpg), bpg=bpg, bgroups=_cdiv(n, bpg),
                smem=32 * hn + 8 * tw * th + 4, fuse_grid=int(_cdiv(c, cpg) == 1))


def _flat_dims(x: torch.Tensor) -> Tuple[list, list]:
    """x's dims for a linear walk, outermost first, with adjacent dims
    merged where their strides allow, padded to 4."""
    dims = sorted(((s, st) for s, st in zip(x.shape, x.stride()) if s != 1),
                  key=lambda d: -d[1])
    merged = []
    for s, st in dims:
        if merged and merged[-1][1] == st * s:
            merged[-1] = (merged[-1][0] * s, st)
        else:
            merged.append((s, st))
    merged = [(1, 0)] * (4 - len(merged)) + merged
    return [s for s, _ in merged], [st for _, st in merged]


def plan(img: torch.Tensor, grid: torch.Tensor, align_corners: bool,
         gout: Optional[torch.Tensor] = None, out: Optional[torch.Tensor] = None,
         route: Optional[str] = None, fuse_grid: bool = True) -> dict:
    """Every number of a call's launches (``ARG_NAMES``): shapes, strides
    (out is the forward's output or the image gradient), the forward's
    plan and, with ``gout``, the backward's: ``route`` "owner" (an output of
    the image's size; the default for it from OWNER_MIN_PIXELS pixels up) or
    "scatter", the owner kernel's
    plan, the scale's sum and the escape count's blocks, the scatter's lanes,
    the table passes' blocks."""
    n, h, w, c = img.shape
    ho, wo = grid.shape[1:3]
    shared = n == 1 or grid.stride(0) == 0
    packed4 = (img.stride(3) == 1 and c % 4 == 0 and c > 1
               and all(s % 4 == 0 for s in img.stride()[:3]) and img.data_ptr() % 16 == 0)
    a = dict(nfields=len(ARG_NAMES), n=n, h=h, w=w, c=c, ho=ho, wo=wo, align=int(align_corners),
             shared=int(shared))
    for name, x in (("img", img), ("grid", grid), ("gout", gout), ("out", out)):
        for d, st in zip("nyxc", x.stride() if x is not None else (0, 0, 0, 0)):
            a[f"{name}_{d}"] = st
    a.update(forward_plan(n, ho, wo, c, shared, packed4))
    if route is None:
        route = "owner" if (ho, wo) == (h, w) and h * w >= OWNER_MIN_PIXELS else "scatter"
    if route not in ("owner", "scatter") or (route == "owner" and (ho, wo) != (h, w)):
        raise ValueError(f"grid_sample: no route {route!r} for img {tuple(img.shape)} and grid "
                         f"{tuple(grid.shape)} (the owner route needs an output of the "
                         f"image's size)")
    a.update(owner_plan(n, h, w, c, shared) if route == "owner" else
             dict(radius=OWNER_RADIUS, tw=0, th=0, tiles_x=0, tiles_y=0, cpg=0, cgroups=0,
                  bpg=0, bgroups=0, smem=0, fuse_grid=0))
    a.update(route=int(route == "owner"), fuse_grid=int(fuse_grid and a["fuse_grid"]))
    # the owner kernel reads gout and writes the image gradient four channels
    # at a time where both are channels-last and 16-byte aligned
    a["owner_vec4"] = int(route == "owner" and c % 4 == 0 and all(
        x is not None and x.stride(3) == 1 and all(st % 4 == 0 for st in x.stride()[:3])
        for x in (gout, out)) and gout.data_ptr() % 16 == 0)
    numel = gout.numel() if gout is not None else 0
    nsum = max(1, min(MAX_SUM_BLOCKS, _cdiv(numel, SUM_BLOCK_ELEMS)))
    chunk = max(1, _cdiv(numel, nsum))
    npix_grid = (1 if shared else n) * ho * wo
    ncnt = min(MAX_COUNT_BLOCKS, _cdiv(npix_grid, BLOCK)) if route == "owner" else 0
    sz, st = _flat_dims(gout) if gout is not None else ([1] * 4, [0] * 4)
    lanes = min(_p2(_cdiv(c, CHUNK)), 32)  # at most CHUNK channels a lane
    iters = _cdiv(n * ho * wo, BLOCK // lanes)
    a.update(nsum=_cdiv(numel, chunk) if numel else 0, sum_chunk=chunk, ncnt=ncnt,
             sc_lanes=lanes, sc_iters=iters, sc_blocks=min(iters, MAX_BLOCKS),
             numel=img.numel(), tbl_blocks=max(1, min(_cdiv(img.numel(), BLOCK), MAX_BLOCKS)))
    a.update({f"gsz{i}": sz[i] for i in range(4)})
    a.update({f"gst{i}": st[i] for i in range(4)})
    return a


def _pack(a: dict):
    return (ctypes.c_longlong * len(ARG_NAMES))(*(int(a[k]) for k in ARG_NAMES))


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


def _corners_plain(grid: torch.Tensor, h: int, w: int, align_corners: bool):
    """The kernels' corners of every sample, each float32 operation rounded
    on its own, in PyTorch's order: (x0, y0) int64 [N, Ho, Wo], the four
    weights (nw, ne, sw, se) and whether each corner lies in the image."""
    def unnormalize(x, size):
        x1 = x + 1.0
        return (x1 * 0.5) * float(size - 1) if align_corners else (x1 * float(size) - 1.0) * 0.5

    ix, iy = unnormalize(grid[..., 0], w), unnormalize(grid[..., 1], h)
    fx, fy = torch.floor(ix), torch.floor(iy)
    ax, ay = (fx + 1.0) - ix, (fy + 1.0) - iy
    ex, ey = ix - fx, iy - fy
    weights = (ax * ay, ex * ay, ax * ey, ex * ey)
    near = (fx > -2.0) & (fx < w + 1.0) & (fy > -2.0) & (fy < h + 1.0)
    x0 = torch.where(near, fx, torch.full_like(fx, -2.0)).to(torch.int64)
    y0 = torch.where(near, fy, torch.full_like(fy, -2.0)).to(torch.int64)
    valid = []
    for dy in (0, 1):
        for dx in (0, 1):
            valid.append(near & (x0 + dx >= 0) & (x0 + dx < w) & (y0 + dy >= 0) & (y0 + dy < h))
    return x0, y0, weights, valid


def escape_count_plain(grid: torch.Tensor, h: int, w: int, tw: int, th: int,
                       radius: int = OWNER_RADIUS, align_corners: bool = False) -> int:
    """The owner route's premise, restated, for an output of the image's
    size h x w cut into tiles of tw x th cells (``owner_plan``). A tile's
    window of output pixels is the tile moved by minus the displacement
    (sx, sy) = nw corner - pixel of the sample of its centre pixel (0 for a
    sample that reads nothing), widened by ``radius`` cells on each side.
    The count is the number of output pixels (of every batch item) with a
    corner in the image whose tile's window does not hold the pixel; the
    owner route is exact when it is 0."""
    x0, y0, _, valid = _corners_plain(grid, h, w, align_corners)
    n = x0.shape[0]
    dev = grid.device
    cx = torch.clamp(torch.arange(_cdiv(w, tw), device=dev) * tw + tw // 2, max=w - 1)
    cy = torch.clamp(torch.arange(_cdiv(h, th), device=dev) * th + th // 2, max=h - 1)
    far = x0 == -2  # the sample reads nothing (-2 is no corner of a near sample)
    shift_x = torch.where(far, 0, x0 - torch.arange(w, device=dev))[:, cy][:, :, cx]
    shift_y = torch.where(far, 0, y0 - torch.arange(h, device=dev).view(-1, 1))[:, cy][:, :, cx]
    py = torch.arange(h, device=dev).view(1, -1, 1)
    px = torch.arange(w, device=dev).view(1, 1, -1)
    b = torch.arange(n, device=dev).view(-1, 1, 1)
    out = torch.zeros(x0.shape, dtype=torch.bool, device=dev)
    for i, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        tx, ty = (x0 + dx).clamp(0, w - 1) // tw, (y0 + dy).clamp(0, h - 1) // th
        wx = px + shift_x[b, ty, tx] - tx * tw
        wy = py + shift_y[b, ty, tx] - ty * th
        out |= valid[i] & ((wx < -radius) | (wx >= tw + radius) | (wy < -radius)
                           | (wy >= th + radius))
    return int(out.sum())


def grid_sample_bwd_fixed_plain(img: torch.Tensor, grid: torch.Tensor, gout: torch.Tensor,
                                scale: torch.Tensor, align_corners: bool = False
                                ) -> torch.Tensor:
    """The plain version of the kernels' image gradient at the fixed-point
    scale ``scale`` (a float32 2^k, or NaN): the int64 sum over every sample
    and corner in the image of rint_even(w * gout * 2^k) (float32 products;
    an addend whose scaled value is not below 2^62 in magnitude is left
    out, as the kernels leave it out and set their flag), times 2^-k. NHWC,
    contiguous."""
    n, h, w, c = img.shape
    x0, y0, weights, valid = _corners_plain(grid, h, w, align_corners)
    scale = scale.reshape(()).to(torch.float32)
    b = torch.arange(n, device=img.device).view(-1, 1, 1)
    table = torch.zeros(n * h * w * c, dtype=torch.int64, device=img.device)
    chans = torch.arange(c, device=img.device)
    for i, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        x = (weights[i].unsqueeze(-1) * gout.float()) * scale
        ok = valid[i].unsqueeze(-1) & (x.abs() < 2.0**62)
        q = torch.where(ok, torch.round(torch.where(ok, x, torch.zeros_like(x))),
                        torch.zeros_like(x)).to(torch.int64)
        cell = ((b * h + (y0 + dy).clamp(0, h - 1)) * w + (x0 + dx).clamp(0, w - 1)) * c
        with fixed_point.integer_atomics():
            table.index_add_(0, (cell.unsqueeze(-1) + chans).reshape(-1), q.reshape(-1))
    return (table.to(torch.float32) * (1.0 / scale)).reshape(n, h, w, c)


class _GridSampleKernels:
    """Wrapper of the kernels of ``csrc/grid_sample.cu`` with their launch
    counts: ``launches`` (forward kernel), ``bwd_launches`` (backward calls),
    ``owner_launches`` / ``scatter_launches`` (backward calls that launched
    the owner kernel / that took the scatter route by shape or by request),
    ``bwd_kernels`` (kernels launched by backward calls); ``fallbacks()``
    reads the device count of owner-route calls whose escape count was not 0
    (their image gradient came from the scatter route). A call's checks and
    plan are kept by its shapes, strides and options: a training step's
    calls repeat, and the host's time per call is what small levels cost."""

    def __init__(self, cuda_lib: CudaLib):
        self.cuda_lib = cuda_lib
        self.launches = 0  # forward kernel
        self.bwd_launches = 0
        self.owner_launches = 0
        self.scatter_launches = 0
        self.bwd_kernels = 0
        self.last_work: Optional[torch.Tensor] = None
        self._sync: Dict[Tuple[torch.device, int], torch.Tensor] = {}
        self._plans: Dict[tuple, tuple] = {}
        self._loaded: Optional[ctypes.CDLL] = None

    def reset(self) -> None:
        self.launches = self.bwd_launches = self.owner_launches = 0
        self.scatter_launches = self.bwd_kernels = 0

    def _lib(self) -> ctypes.CDLL:
        if self._loaded is None:
            lib = self.cuda_lib.lib()
            lib.grid_sample_fwd.restype = ctypes.c_int
            lib.grid_sample_fwd.argtypes = [ctypes.c_void_p] * 5
            lib.grid_sample_bwd.restype = ctypes.c_int
            lib.grid_sample_bwd.argtypes = [ctypes.c_void_p] * 12
            self._loaded = lib
        return self._loaded

    def fallbacks(self) -> int:
        """Owner-route calls (since the wrapper was made) whose image gradient
        the scatter route computed. Syncs."""
        return sum(int(t[1]) for t in self._sync.values())

    @property
    def last_scale(self) -> torch.Tensor:
        """The last backward call's fixed-point scale, a float32 [1] on its device."""
        return self.last_work[0:4].view(torch.float32)

    @property
    def last_count(self) -> torch.Tensor:
        """The last backward call's escape count, an int32 [1] on its device."""
        return self.last_work[8:12].view(torch.int32)

    def _plan(self, img, grid, gout, align_corners, route=None, fuse_grid=True) -> tuple:
        """(packed arguments, out in channels-first planes, work bytes, the
        owner route): checked and planned once per signature."""
        key = (img.dtype, grid.dtype, img.device, grid.device, img.shape, img.stride(),
               grid.shape, grid.stride(), img.data_ptr() % 16 == 0, bool(align_corners),
               None if gout is None else (gout.dtype, gout.shape, gout.stride(),
                                          gout.data_ptr() % 16 == 0), route, fuse_grid)
        hit = self._plans.get(key)
        if hit is not None:
            return hit
        _check(img, grid)
        n, h, w, c = img.shape
        ho, wo = grid.shape[1:3]
        planar = channels_first(img)
        out = _empty_nhwc(n, h, w, c, planar, "meta") if gout is not None else _empty_nhwc(
            n, ho, wo, c, planar, "meta")
        if gout is not None and (gout.dtype != torch.float32
                                 or tuple(gout.shape) != (n, ho, wo, c)):
            raise ValueError(f"grid_sample: gout must be float32 {(n, ho, wo, c)}, got "
                             f"{gout.dtype} {tuple(gout.shape)}")
        _check_offsets(img=img, grid=grid, out=out, **({} if gout is None else {"gout": gout}))
        a = plan(img, grid, align_corners, gout=gout, out=out, route=route, fuse_grid=fuse_grid)
        hit = (_pack(a), planar, META_BYTES + 8 * a["nsum"] + 4 * a["ncnt"], bool(a["route"]))
        if len(self._plans) >= 512:
            self._plans.clear()
        self._plans[key] = hit
        return hit

    @staticmethod
    def _stream(dev: torch.device) -> int:
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        return raw(dev.index) if raw is not None else torch.cuda.current_stream(dev).cuda_stream

    def _launch(self, dev: torch.device, fn, *args) -> int:
        if dev.index == torch.cuda.current_device():
            return fn(*args)
        with torch.cuda.device(dev):
            return fn(*args)

    def forward(self, img: torch.Tensor, grid: torch.Tensor, align_corners: bool = False):
        args, planar, _, _ = self._plan(img, grid, None, align_corners)
        n, _, _, c = img.shape
        ho, wo = grid.shape[1:3]
        dev = img.device
        out = _empty_nhwc(n, ho, wo, c, planar, dev)
        if out.numel() == 0:
            return out
        err = self._launch(dev, self._lib().grid_sample_fwd, img.data_ptr(), grid.data_ptr(),
                           out.data_ptr(), ctypes.addressof(args), self._stream(dev))
        self.cuda_lib.check(err, "grid_sample_fwd launch")
        self.launches += 1
        return out

    def backward(self, img, grid, gout, align_corners=False, need_img=True, need_grid=True,
                 route: Optional[str] = None, fuse_grid: bool = True):
        """(d img or None, d grid or None); ``plan`` picks the route.
        ``route`` and ``fuse_grid`` are for tests and measurements only:
        "owner" or "scatter" forces a route (the owner route still stands
        down where the escape count is not 0); ``fuse_grid`` False leaves the
        owner route's grid gradient to the scatter kernel."""
        args, planar, work_bytes, owner = self._plan(img, grid, gout, align_corners, route,
                                                      fuse_grid)
        n, h, w, c = img.shape
        ho, wo = grid.shape[1:3]
        dev = img.device
        gimg = _empty_nhwc(n, h, w, c, planar, dev) if need_img else None
        ggrid = (torch.empty((n, ho, wo, 2), dtype=torch.float32, device=dev)
                 if need_grid else None)
        if not (need_img or need_grid):
            return None, None
        if gout.numel() == 0 or img.numel() == 0:
            return (None if gimg is None else gimg.zero_()), (
                None if ggrid is None else ggrid.zero_())
        stream = self._stream(dev)
        work = q = None
        if need_img:
            work = torch.empty(work_bytes, dtype=torch.uint8, device=dev)
            q = torch.empty_strided(gimg.shape, gimg.stride(), dtype=torch.int64, device=dev)
        sync = self._sync.get((dev, stream))
        if sync is None:  # the prep's arrival count (kept 0) and the fallbacks
            sync = self._sync[(dev, stream)] = torch.zeros(2, dtype=torch.int32, device=dev)
        ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
        launched = ctypes.c_int(0)
        err = self._launch(dev, self._lib().grid_sample_bwd, img.data_ptr(), grid.data_ptr(),
                           gout.data_ptr(), ptr(gimg), ptr(ggrid), ptr(work), ptr(q),
                           sync.data_ptr(), fixed_point.flag(dev).data_ptr(),
                           ctypes.addressof(args), ctypes.addressof(launched), stream)
        self.cuda_lib.check(err, "grid_sample_bwd launch")
        self.bwd_launches += 1
        self.bwd_kernels += launched.value
        if owner:
            self.owner_launches += 1
        else:
            self.scatter_launches += 1
        self.last_work = work
        return gimg, ggrid


grid_sample_kernels = _GridSampleKernels(GRID_SAMPLE_LIB)
graphs.count_launches(grid_sample_kernels, "launches", "bwd_launches", "owner_launches",
                      "scatter_launches", "bwd_kernels")


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
