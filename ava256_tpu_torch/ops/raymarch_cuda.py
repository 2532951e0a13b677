# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""MVP raymarch on the GPU: tile culling in PyTorch, the march, its composite
and their backward in hand-written CUDA kernels (``csrc/mvp_march_fwd.cu``,
``csrc/mvp_march_bwd.cu``).

Port of ``ava256_tpu.ops.raymarch_pallas``:

1. Culling (``tile_and_cull``): the image is cut into tile x tile ray tiles;
   each tile's ray cone is tested against every primitive's bounding sphere
   (dense) or first against Morton-ordered groups (two-stage, K >= 65536),
   and the ``max_hit`` earliest-reachable primitives are kept, in depth
   order. This ran in XLA beside the Pallas kernels, so it is PyTorch here.
2. The march (``march_tiles``): per tile, sum every step row's samples over
   the candidates in order, then composite the rows front to back with
   saturation (summed-within-step). On a CUDA tensor this launches the
   kernel; on a CPU tensor it runs the plain PyTorch version,
   ``march_tiles_plain``, which repeats the kernel's arithmetic.
   When asked, the march also returns each ray's state [NT, 8, T2]: the row
   sums (rgb, a) of the step row where the density sum crosses 1 (zeros if
   it never does), the final alpha, and the extremes of the template cells
   the ray's samples read (max |rgb|, max |alpha|, min(0, alpha)).
3. Its backward (``march_tiles_bwd``): from the cotangent of the composited
   tiles and the forward's saturation state, the gradients of the template
   and warp boxes and of every primitive's affine, summed over the tiles.
   Kernel on CUDA tensors, ``march_tiles_bwd_plain`` on CPU tensors. Without
   a state it runs the forward march once more to get it. The kernel's sums
   are integer sums at a per-call fixed-point scale (``fixed_point_bounds``,
   ``ops/fixed_point.py``), bounded over the template cells the forward's
   samples read: it gives the same bits on every run.
4. The op (``mvp_raymarch_cuda``): one ``torch.autograd.Function`` that culls
   on the values, marches (saving the state when a gradient is needed), and
   in the backward marches with the forward's saved candidates and state;
   the affine gradients go on to primpos, primrot and primscale in PyTorch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ava256_tpu_torch.ops import fixed_point, graphs
from ava256_tpu_torch.ops.cuda_lib import CudaLib
from ava256_tpu_torch.train.profiling import annotate, recording

MARCH_FWD_LIB = CudaLib("mvp_march_fwd.cu")
MARCH_BWD_LIB = CudaLib("mvp_march_bwd.cu")
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
WINDOW = 16  # step rows marched per window, as kWindow in the kernels
# the forward's per-ray state: C_s (rgb), a_s, alpha, then the extremes of the
# template cells read: max |rgb|, max |alpha|, min(0, alpha)
STATE_ROWS = 8


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """jnp.hypot's formula, so that candidate depth keys round as in JAX."""
    x, y = torch.abs(x), torch.abs(y)
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    q = lo / torch.where(hi == 0, torch.ones_like(hi), hi)
    r = torch.where(hi == 0, hi, hi * torch.sqrt(1 + q * q))
    return torch.where(torch.isposinf(x) | torch.isposinf(y), torch.full_like(r, math.inf), r)


def _smallest(key: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest keys per row, ties broken by lower index (the order
    jax.lax.top_k(-key, k) returns)."""
    vals, idx = torch.sort(key, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


# ---------------------------------------------------------------------------
# Culling
# ---------------------------------------------------------------------------


def _cone_test(centers, rads, live, apex, axis, tanmax, dmax, tile_tmin, tile_tmax, dt):
    """Per-tile cone-vs-sphere test. centers [NT, P, 3], rads/live [NT, P];
    the other arguments are per-tile cone quantities. Returns (hit [NT, P],
    t_start [NT, P]), t_start a sound lower bound on the first ray parameter
    at which the sphere can contribute for any ray of the tile."""
    v = centers - apex[:, None, :]
    t_c = torch.sum(v * axis[:, None, :], dim=-1)
    dist = _norm(v - t_c[..., None] * axis[:, None, :])
    hit = (
        (dist <= rads + torch.clamp(t_c, min=0.0) * tanmax[:, None] + dt)
        & (t_c + rads >= tile_tmin[:, None])
        & (t_c - rads <= tile_tmax[:, None])
        & (tile_tmax > tile_tmin)[:, None]
        & live
    )
    t_start = t_c - rads - _hypot(t_c, dist) * dmax[:, None]
    return hit, t_start


def _morton_spread(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x to every third bit."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton_order(primpos: torch.Tensor, live_nk: torch.Tensor) -> torch.Tensor:
    """[N, K] primitive order by 30-bit Morton code over each batch item's
    live bounding box; dead primitives sort last."""
    big = 1e9
    lo = torch.amin(torch.where(live_nk[..., None], primpos, big), dim=1, keepdim=True)
    hi = torch.amax(torch.where(live_nk[..., None], primpos, -big), dim=1, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp((primpos - lo) / span * 1023.0, 0.0, 1023.0).to(torch.int64)
    code = ((_morton_spread(q[..., 0]) << 2) | (_morton_spread(q[..., 1]) << 1)
            | _morton_spread(q[..., 2]))
    code = torch.where(live_nk, code, torch.full_like(code, 0xFFFFFFFF))
    return torch.argsort(code, dim=1, stable=True)


def tile_view(x: torch.Tensor, tile: int) -> torch.Tensor:
    """[N, Hp, Wp, C] -> [N * nty * ntx, C, tile * tile], rays row-major in a tile."""
    n, hp, wp, ch = x.shape
    x = x.reshape(n, hp // tile, tile, wp // tile, tile, ch).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(-1, ch, tile * tile).contiguous()


@dataclasses.dataclass
class CullCounts:
    """Sums over the two-stage culls made while a profiler records (each a
    Python int, or a 0-d int64 tensor on the culls' device until read):
    tiles culled, tiles whose ``cull_max_groups`` group slots were all
    taken (so any further group that reached the tile was cut), tiles whose
    ``max_hit`` candidate slots were all valid, and valid candidates."""

    tiles: Any = 0
    groups_full: Any = 0
    candidates_full: Any = 0
    candidates: Any = 0


CULL_COUNTS = CullCounts()


def take_cull_counts() -> Dict[str, int]:
    """``CULL_COUNTS`` as ints (one host sync), then back to zero."""
    out = {k: int(v) for k, v in dataclasses.asdict(CULL_COUNTS).items()}
    for k in out:
        setattr(CULL_COUNTS, k, 0)
    return out


def _count_cull(gvalid: torch.Tensor, cand_valid: torch.Tensor) -> None:
    """Add one two-stage cull to ``CULL_COUNTS`` on the device, with no sync."""
    c = CULL_COUNTS
    c.tiles = c.tiles + cand_valid.shape[0]
    c.groups_full = c.groups_full + torch.all(gvalid, dim=1).sum()
    c.candidates_full = c.candidates_full + torch.all(cand_valid, dim=1).sum()
    c.candidates = c.candidates + cand_valid.sum()


def tile_and_cull(raypos, raydir, tminmax, primpos, primscale, prim_mask, tile, max_hit, dt,
                  cull_group_size=256, cull_max_groups=8, two_stage=None):
    """Returns (t_o, t_d, t_mm [NT, C, T2], cand_gid [NT, MH] int64 into the
    flat N*K table, cand_valid [NT, MH], cand_tstart [NT, MH], meta).

    The two-stage branch runs in two spans (``annotate``): from the Morton
    order to each tile's earliest ``cull_max_groups`` groups,
    ``ava:raymarch.cull.groups``; from the gather of the kept groups'
    members to the earliest ``max_hit``, ``ava:raymarch.cull.members``.
    While a profiler records it also adds to ``CULL_COUNTS`` (read and reset
    by ``take_cull_counts``); outside one it counts nothing. The dense
    branch opens no span of its own and counts nothing."""
    n, h, w = raypos.shape[0], raypos.shape[1], raypos.shape[2]
    K = primpos.shape[1]
    hp, wp = _ceil_to(h, tile), _ceil_to(w, tile)
    pad = (0, 0, 0, wp - w, 0, hp - h)
    t_o = tile_view(torch.nn.functional.pad(raypos, pad), tile)
    t_d = tile_view(torch.nn.functional.pad(raydir, pad, value=1.0), tile)
    t_mm = tile_view(torch.nn.functional.pad(tminmax, pad, value=0.0), tile)
    nty, ntx = hp // tile, wp // tile
    ntiles = n * nty * ntx
    tile_b = torch.arange(ntiles, device=raypos.device) // (nty * ntx)

    radii = _norm(1.0 / primscale)  # [N, K]
    apex = t_o[:, :, 0]
    dsum = torch.sum(t_d, dim=2)
    axis = dsum / _norm(dsum)[:, None]
    cosang = torch.sum(t_d * axis[:, :, None], dim=1)  # [NT, T2]
    cosmin = torch.clamp(torch.amin(cosang, dim=1), min=1e-3)
    tanmax = torch.sqrt(torch.clamp(1.0 - cosmin**2, 0.0, 1.0)) / cosmin
    dmax = torch.sqrt(torch.clamp(2.0 * (1.0 - cosmin), 0.0, 4.0))
    live = t_mm[:, 0] < t_mm[:, 1]
    big = 1e9
    tile_tmin = torch.amin(torch.where(live, t_mm[:, 0], big), dim=1)
    tile_tmax = torch.amax(torch.where(live, t_mm[:, 1], -big), dim=1)
    cone = (apex, axis, tanmax, dmax, tile_tmin, tile_tmax, dt)
    live_nk = prim_mask > 0.5

    if two_stage is None:
        two_stage = K >= 65536
    if two_stage:
        # Morton-sort the primitives, test each tile against the bounding
        # spheres of groups of g consecutive ones, keep the earliest
        # cull_max_groups groups and test their members exactly.
        with annotate("ava:raymarch.cull.groups"):
            g = max(1, min(cull_group_size, K))
            G = -(-K // g)
            Kp = G * g
            order_s = _morton_order(primpos, live_nk)
            pos_s = torch.gather(primpos, 1, order_s[..., None].expand(-1, -1, 3))
            rad_s = torch.gather(radii, 1, order_s)
            live_s = torch.gather(live_nk, 1, order_s)
            if Kp > K:
                pos_s = torch.nn.functional.pad(pos_s, (0, 0, 0, Kp - K))
                rad_s = torch.nn.functional.pad(rad_s, (0, Kp - K))
                live_s = torch.nn.functional.pad(live_s, (0, Kp - K))
                order_s = torch.nn.functional.pad(order_s, (0, Kp - K))
            mem = pos_s.reshape(n, G, g, 3)
            mem_rad = rad_s.reshape(n, G, g)
            mem_live = live_s.reshape(n, G, g)
            lo = torch.amin(torch.where(mem_live[..., None], mem, big), dim=2)
            hi = torch.amax(torch.where(mem_live[..., None], mem, -big), dim=2)
            any_live = torch.any(mem_live, dim=2)
            cg = 0.5 * (lo + hi)
            rg = torch.amax(torch.where(mem_live, _norm(mem - cg[:, :, None]) + mem_rad,
                                        torch.zeros_like(mem_rad)), dim=2)
            ghit, gstart = _cone_test(cg[tile_b], rg[tile_b], any_live[tile_b], *cone)
            gkey = torch.where(ghit, gstart, math.inf)
            M = min(cull_max_groups, G)
            gkey_top, gorder = _smallest(gkey, M)
            gvalid = torch.isfinite(gkey_top)
        with annotate("ava:raymarch.cull.members"):
            sel = tile_b[:, None] * G + gorder  # [NT, M] rows of the [N*G] group table
            centers = mem.reshape(n * G, g, 3)[sel].reshape(ntiles, M * g, 3)
            rads = mem_rad.reshape(n * G, g)[sel].reshape(ntiles, M * g)
            live_c = mem_live.reshape(n * G, g)[sel].reshape(ntiles, M * g) & \
                torch.repeat_interleave(gvalid, g, dim=1)
            cand_local = order_s.reshape(n * G, g)[sel].reshape(ntiles, M * g)
            hit, t_start = _cone_test(centers, rads, live_c, *cone)
            key = torch.where(hit, t_start, math.inf)
            cand_tstart, order = _smallest(key, min(max_hit, key.shape[1]))
            cand_valid = torch.isfinite(cand_tstart)
            gids = tile_b[:, None] * K + torch.gather(cand_local, 1, order)
        if recording():
            _count_cull(gvalid, cand_valid)
    else:
        hit, t_start = _cone_test(primpos[tile_b], radii[tile_b], live_nk[tile_b], *cone)
        key = torch.where(hit, t_start, math.inf)
        cand_tstart, order = _smallest(key, min(max_hit, K))
        cand_valid = torch.isfinite(cand_tstart)
        gids = tile_b[:, None] * K + order
    cand_gid = torch.where(cand_valid, gids, torch.zeros_like(gids))
    meta = dict(n=n, h=h, w=w, hp=hp, wp=wp, nty=nty, ntx=ntx, ntiles=ntiles)
    return t_o, t_d, t_mm, cand_gid, cand_valid, cand_tstart, meta


def untile(out: torch.Tensor, meta: Dict[str, int], tile: int) -> torch.Tensor:
    """[NT, 4, T2] -> [N, H, W, 4]."""
    n, nty, ntx = meta["n"], meta["nty"], meta["ntx"]
    out = out.reshape(n, nty, ntx, 4, tile, tile).permute(0, 1, 4, 2, 5, 3)
    return out.reshape(n, meta["hp"], meta["wp"], 4)[:, : meta["h"], : meta["w"], :]


def candidate_affines(primpos, primrot, primscale, cand_gid, cand_valid) -> torch.Tensor:
    """[NT, MH, 12]: A = R diag(s) row-major, then b = -c @ A. Invalid
    candidates get A = 0, b = 4, an empty slab interval."""
    ntiles, mh = cand_gid.shape
    A = primrot.reshape(-1, 3, 3)[cand_gid] * primscale.reshape(-1, 3)[cand_gid][..., None, :]
    b = -torch.sum(primpos.reshape(-1, 3)[cand_gid][..., :, None] * A, dim=-2)
    valid_f = cand_valid.to(A.dtype)[..., None]
    A = A * valid_f[..., None]
    b = b * valid_f + (1.0 - valid_f) * 4.0
    return torch.cat([A.reshape(ntiles, mh, 9), b], dim=-1).contiguous()


# ---------------------------------------------------------------------------
# The march: plain PyTorch version and the CUDA kernel's wrapper
# ---------------------------------------------------------------------------


def _pow_abs(x: torch.Tensor, p: float) -> torch.Tensor:
    """|x|^p; integer p in [1, 16] by repeated squaring, as the kernel does."""
    if float(p).is_integer() and 1 <= int(p) <= 16:
        n, a, out = int(p), torch.abs(x), None
        acc = a
        while n:
            if n & 1:
                out = acc if out is None else out * acc
            acc = acc * acc
            n >>= 1
        return out
    return torch.abs(x) ** p


def _trilinear_plain(vol: torch.Tensor, bs: int, fx, fy, fz, extremes: bool = False):
    """vol [NT, bs^3, C] (one box per tile), f* [NT, R] cell coordinates ->
    [NT, R, C]; corners outside the box read zero (a select, so that what
    lies in the clamped cell does not matter). Same sum order as the kernel's
    trilinear(). With ``extremes`` (RGBA boxes) also the kernel's
    ReadExtremes of each sample's corners, [3, NT, R]: max |rgb|, max
    |alpha|, min(0, alpha), NaN where a corner read is NaN."""
    x0, y0, z0 = torch.floor(fx), torch.floor(fy), torch.floor(fz)
    wx1, wy1, wz1 = fx - x0, fy - y0, fz - z0
    c = vol.shape[-1]
    out, corners = 0.0, []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi, zi = x0 + dx, y0 + dy, z0 + dz
                ok = ((xi >= 0) & (xi <= bs - 1) & (yi >= 0) & (yi <= bs - 1)
                      & (zi >= 0) & (zi <= bs - 1))
                idx = ((torch.clamp(zi, 0, bs - 1) * bs + torch.clamp(yi, 0, bs - 1)) * bs
                       + torch.clamp(xi, 0, bs - 1)).long()
                vals = torch.gather(vol, 1, idx[..., None].expand(-1, -1, c))
                wgt = ((wx1 if dx else 1.0 - wx1) * (wy1 if dy else 1.0 - wy1)
                       * (wz1 if dz else 1.0 - wz1))
                v = torch.where(ok[..., None], vals, 0.0)
                out = out + v * wgt[..., None]
                corners.append(v)
    if not extremes:
        return out
    v = torch.stack(corners)  # [8, NT, R, 4]; amax and amin keep a NaN
    top = v.abs().amax(dim=0)
    return out, torch.stack([top[..., :3].amax(dim=-1), top[..., 3],
                             torch.clamp(v[..., 3].amin(dim=0), max=0.0)])


def _slab_plain(s: torch.Tensor, o, d, tmin, tmax):
    """The kernel's slab(): s [NT, 12] per-tile affine, o/d tuples of
    [NT, T2] ray components -> local ray, tin, tout, seg."""
    oy, dy, lo, hi = [], [], [], []
    for j in range(3):
        oc = o[0] * s[:, None, j] + o[1] * s[:, None, 3 + j] + o[2] * s[:, None, 6 + j] \
            + s[:, None, 9 + j]
        dc = d[0] * s[:, None, j] + d[1] * s[:, None, 3 + j] + d[2] * s[:, None, 6 + j]
        oy.append(oc)
        dy.append(dc)
        eps = torch.where(dc >= 0, 1e-9, -1e-9)
        dc = torch.where(torch.abs(dc) < 1e-9, eps, dc)
        t1 = (-1.0 - oc) / dc
        t2 = (1.0 - oc) / dc
        lo.append(torch.minimum(t1, t2))
        hi.append(torch.maximum(t1, t2))
    tin = torch.maximum(torch.maximum(torch.maximum(lo[0], lo[1]), lo[2]), tmin)
    tout = torch.minimum(torch.minimum(torch.minimum(hi[0], hi[1]), hi[2]), tmax)
    return oy, dy, tin, tout, tin < tout


def _row_ranges(scal, o, d, tmin, tmax, dt, nbuf):
    """Per-(tile, candidate) step-row ranges [r0, r1) with the kernel's
    one-row margins: rows outside are masked for every ray of the tile."""
    ntiles, mh = scal.shape[:2]
    r0 = torch.full((ntiles, mh), nbuf, dtype=torch.int64, device=tmin.device)
    r1 = torch.zeros((ntiles, mh), dtype=torch.int64, device=tmin.device)
    for c in range(mh):
        _, _, tin, tout, seg = _slab_plain(scal[:, c], o, d, tmin, tmax)
        lo = torch.where(seg, torch.floor((tin - tmin) / dt) - 1.0, float(nbuf))
        hi = torch.where(seg, torch.ceil((tout - tmin) / dt) + 1.0, 0.0)
        r0[:, c] = torch.clamp(torch.amin(lo, dim=1), min=0.0).long()
        r1[:, c] = torch.clamp(torch.amax(hi, dim=1), max=float(nbuf)).long()
    return r0, r1


def ray_candidates_plain(scal, t_o, t_d, t_mm, dt, nbuf):
    """The rows each thread of the kernels walks (``row_range`` in
    csrc/mvp_march_common.cuh): hit [NT, T2, MH], true where the ray's slab
    interval of the candidate is not empty, and the ray's own step rows
    [lo, hi) of it [NT, T2, MH], with one row of margin on either side,
    clamped to [0, nbuf] (0, 0 where it misses). The kernels evaluate a
    (ray, row, candidate) sample only inside them."""
    o = tuple(t_o[:, j] for j in range(3))
    d = tuple(t_d[:, j] for j in range(3))
    tmin, tmax = t_mm[:, 0], t_mm[:, 1]
    hit, lo, hi = [], [], []
    for c in range(scal.shape[1]):
        _, _, tin, tout, seg = _slab_plain(scal[:, c], o, d, tmin, tmax)
        lo_c = torch.clamp(torch.floor((tin - tmin) / dt) - 1.0, 0.0, float(nbuf))
        hi_c = torch.clamp(torch.ceil((tout - tmin) / dt) + 1.0, 0.0, float(nbuf))
        lo_c = torch.where(seg, lo_c, torch.zeros_like(lo_c)).long()
        hi_c = torch.where(seg, hi_c, torch.zeros_like(hi_c)).long()
        hit.append(seg & (lo_c < hi_c))
        lo.append(lo_c)
        hi.append(hi_c)
    return torch.stack(hit, dim=-1), torch.stack(lo, dim=-1), torch.stack(hi, dim=-1)


class _TileMarch:
    """The tiles' inputs unpacked once, and the kernels' shared steps as
    PyTorch ops: one candidate's samples over a window of rows
    (``eval_sample`` in csrc/mvp_march_common.cuh), a window's row sums
    (``march_window``) and a tile's early exit (``tile_done``). The kernels'
    block marches its tile's windows from the tile's own first row; here the
    rows are marched for all tiles at once, in windows from the first row of
    any tile, and a tile stops taking rows where its own window ends with
    every ray done (``exits``)."""

    def __init__(self, gid, scal, t_o, t_d, t_mm, template, warp, dt, fadescale, fadeexp, nbuf):
        self.gid, self.scal = gid.long(), scal
        self.ntiles, self.mh = gid.shape
        self.t2 = t_o.shape[2]
        self.bs = bs = template.shape[1]
        self.dev, self.dtype = t_o.device, t_o.dtype
        self.tpl = template.reshape(template.shape[0], bs**3, 4)
        self.wrp = None if warp is None else warp.reshape(warp.shape[0], bs**3, 3)
        self.o = tuple(t_o[:, j] for j in range(3))
        self.d = tuple(t_d[:, j] for j in range(3))
        self.tmin, self.tmax = t_mm[:, 0], t_mm[:, 1]
        self.half = 0.5 * (bs - 1)
        self.dt, self.fadescale, self.fadeexp, self.nbuf = dt, fadescale, fadeexp, nbuf
        # windows no tile reaches are skipped
        self.r0, self.r1 = _row_ranges(scal, self.o, self.d, self.tmin, self.tmax, dt, nbuf)
        has = self.r1 > self.r0
        self.empty = not bool(has.any())
        self.rmin = 0 if self.empty else int(self.r0[has].min())
        self.rmax = 0 if self.empty else int(self.r1[has].max())
        # each tile's rows [first, last), the span of its windows
        self.first = torch.where(has, self.r0, nbuf).amin(dim=1)
        self.last = torch.where(has, self.r1, 0).amax(dim=1)

    def windows(self):
        for w0 in range(self.rmin, self.rmax, WINDOW):
            yield w0, min(w0 + WINDOW, self.rmax)

    def meeting(self, w0, w1, active):
        """Candidate slots whose row range meets [w0, w1) in an active tile."""
        meets = ((self.r0 < w1) & (self.r1 > w0) & active[:, None]).any(dim=0)
        return torch.nonzero(meets).flatten().tolist()

    def samples(self, c, w0, w1, extremes: bool = False):
        """Candidate slot c at rows [w0, w1): a dict of [NT, T2, R] tensors
        (t, y, fade, mask, u), the cell coordinates f (of y) and f2 (where the
        template is read), each [NT, T2 * R], and the template sample smp
        [NT, T2, R, 4]; with ``extremes`` also ``read`` [3, NT, T2, R], the
        extremes of the template corners each sample reads (0 where the
        mask is off: the kernels take no sample there)."""
        rows = torch.arange(w0, w1, device=self.dev, dtype=self.dtype)
        oy, dy, tin, tout, seg = _slab_plain(self.scal[:, c], self.o, self.d, self.tmin,
                                             self.tmax)
        tmin, tmax = self.tmin, self.tmax
        t = tmin[..., None] + rows * self.dt  # [NT, T2, R]
        y = [oy[j][..., None] + t * dy[j][..., None] for j in range(3)]
        fade = torch.exp(-self.fadescale * (
            _pow_abs(y[0], self.fadeexp) + _pow_abs(y[1], self.fadeexp)
            + _pow_abs(y[2], self.fadeexp)))
        inbox = ((y[0] >= -1.0) & (y[0] <= 1.0) & (y[1] >= -1.0) & (y[1] <= 1.0)
                 & (y[2] >= -1.0) & (y[2] <= 1.0))
        mask = (inbox & seg[..., None] & (t >= tin[..., None]) & (t < tout[..., None])
                & (t >= tmin[..., None]) & (t < tmax[..., None]))
        u = fade * self.dt * mask.to(t.dtype)
        f = [((yj + 1.0) * self.half).reshape(self.ntiles, -1) for yj in y]
        f2 = f
        if self.wrp is not None:
            sw = _trilinear_plain(self.wrp[self.gid[:, c]], self.bs, *f)
            f2 = [(sw[..., j] + 1.0) * self.half for j in range(3)]
        smp = _trilinear_plain(self.tpl[self.gid[:, c]], self.bs, *f2, extremes=extremes)
        sp = dict(t=t, y=y, fade=fade, mask=mask, u=u, f=f, f2=f2)
        if extremes:
            smp, read = smp
            sp["read"] = torch.where(mask, read.reshape((3,) + mask.shape), 0.0)
        # the kernels take no sample where the mask is off: nothing read there counts
        sp["smp"] = torch.where(mask[..., None], smp.reshape(self.ntiles, self.t2, -1, 4), 0.0)
        return sp

    def window_sums(self, w0, w1, active, taken: bool = False, read: bool = False):
        """(acc, taken, read) of rows [w0, w1): acc [4, NT, T2, R], rgb * a
        and a per row, summed over the candidates in candidate order; with
        ``taken``, [NT, R] the samples of each tile's rows; with ``read``,
        [3, NT, T2, R] the extremes of the template corners each ray's samples
        of a row read (max |rgb|, max |alpha|, min(0, alpha)). The caller
        counts a row of a tile only where the tile still marches it."""
        r = w1 - w0
        acc = torch.zeros((4, self.ntiles, self.t2, r), dtype=self.dtype, device=self.dev)
        n = torch.zeros((self.ntiles, r), dtype=torch.int64, device=self.dev) if taken else None
        ext = torch.zeros((3, self.ntiles, self.t2, r), dtype=self.dtype,
                          device=self.dev) if read else None
        for c in self.meeting(w0, w1, active):
            sp = self.samples(c, w0, w1, extremes=read)
            if taken:
                n += sp["mask"].sum(dim=1)
            if read:
                e = sp["read"]
                ext[0] = torch.maximum(ext[0], e[0])
                ext[1] = torch.maximum(ext[1], e[1])
                ext[2] = torch.minimum(ext[2], e[2])
            a = sp["smp"][..., 3] * sp["u"]
            for j in range(3):
                acc[j] = acc[j] + sp["smp"][..., j] * a
            acc[3] = acc[3] + a
        return acc, n, ext

    def exits(self, cum, row: int):
        """Tiles that stop after row ``row``: one of their windows ends
        there and every ray has saturated or can take no further sample
        (``tile_done``)."""
        end = ((row + 1 - self.first) % WINDOW == 0) | (row + 1 == self.last)
        done = ((cum >= 1.0) | ~(self.tmin < self.tmax)
                | (self.tmin + float(row + 1) * self.dt >= self.tmax))
        return end & done.all(dim=1)


def march_tiles_plain(gid, scal, t_o, t_d, t_mm, template, warp, dt, fadescale, fadeexp,
                      nbuf, counts: Optional[Dict[str, torch.Tensor]] = None,
                      with_state: bool = False):
    """Plain PyTorch version of the forward kernel: the same per-tile march
    and composite, looping over windows of step rows and over candidates, and
    vectorized over tiles x rays x the rows of a window. Arguments as for
    ``march_tiles``; returns [NT, 4, T2], with ``with_state`` also the
    rays' state [NT, 8, T2]. ``counts``, when given, gets ``"samples"``:
    the (ray, row, candidate) samples the kernel evaluates on these inputs
    (the tiles' early exit at a window's end included)."""
    m = _TileMarch(gid, scal, t_o, t_d, t_mm, template, warp, dt, fadescale, fadeexp, nbuf)
    cum = torch.zeros_like(m.tmin)
    rgb = [torch.zeros_like(m.tmin) for _ in range(3)]
    sat = [torch.zeros_like(m.tmin) for _ in range(4)]  # row sums of the saturation row
    read = [torch.zeros_like(m.tmin) for _ in range(3)]  # extremes of the cells read
    active = torch.ones(m.ntiles, dtype=torch.bool, device=m.dev)
    for w0, w1 in m.windows():
        acc, taken, seen = m.window_sums(w0, w1, active, taken=counts is not None,
                                         read=with_state)
        marched = []
        for r in range(w1 - w0):
            marched.append(active)
            a = acc[3][..., r]
            nw = cum + a
            scale = (torch.clamp(nw, max=1.0) - torch.clamp(cum, max=1.0)) / torch.clamp(
                a, min=1e-12)
            keep = active[:, None]
            rgb = [torch.where(keep, rgb[j] + scale * acc[j][..., r], rgb[j]) for j in range(3)]
            if counts is not None:
                counts["samples"] = counts.get("samples", 0) + taken[:, r][active].sum()
            if with_state:
                crosses = keep & (cum < 1.0) & (nw >= 1.0)
                sat = [torch.where(crosses, acc[j][..., r], sat[j]) for j in range(4)]
            cum = torch.where(keep, nw, cum)
            active = active & ~m.exits(cum, w0 + r)
        if with_state:  # the rows each tile marched
            seen = torch.where(torch.stack(marched, dim=-1)[None, :, None], seen, 0.0)
            read = [torch.maximum(read[0], seen[0].amax(dim=-1)),
                    torch.maximum(read[1], seen[1].amax(dim=-1)),
                    torch.minimum(read[2], seen[2].amin(dim=-1))]
        if not bool(active.any()):
            break
    alpha = torch.clamp(cum, max=1.0)
    out = torch.stack(rgb + [alpha], dim=1)
    return (out, torch.stack(sat + [alpha] + read, dim=1)) if with_state else out


def _trilinear_bwd_plain(vol, dvol, gid_c, bs, fx, fy, fz, dS):
    """Gradient of ``_trilinear_plain``: vol [NT, bs^3, C] the tiles' boxes,
    dvol [N*K, bs^3, C] the table their gradients are added into at rows
    gid_c [NT], f* [NT, R], dS [NT, R, C]. Returns d/d(fx, fy, fz) of the
    sample dotted with dS, each [NT, R]."""
    x0, y0, z0 = torch.floor(fx), torch.floor(fy), torch.floor(fz)
    wx1, wy1, wz1 = fx - x0, fy - y0, fz - z0
    nbox, cells, ch = dvol.shape
    flat = dvol.view(nbox * cells, ch)
    df = [torch.zeros_like(fx) for _ in range(3)]
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi, zi = x0 + dx, y0 + dy, z0 + dz
                ok = ((xi >= 0) & (xi <= bs - 1) & (yi >= 0) & (yi <= bs - 1)
                      & (zi >= 0) & (zi <= bs - 1))
                idx = ((torch.clamp(zi, 0, bs - 1) * bs + torch.clamp(yi, 0, bs - 1)) * bs
                       + torch.clamp(xi, 0, bs - 1)).long()
                wx = wx1 if dx else 1.0 - wx1
                wy = wy1 if dy else 1.0 - wy1
                wz = wz1 if dz else 1.0 - wz1
                okf = ok.to(fx.dtype)
                vals = torch.gather(vol, 1, idx[..., None].expand(-1, -1, ch))
                dot = torch.sum(torch.where(ok[..., None], vals, 0.0) * dS, dim=-1)
                contrib = dS * (((wx * wy) * wz) * okf)[..., None]
                flat.index_add_(0, (gid_c[:, None] * cells + idx).reshape(-1),
                                contrib.reshape(-1, ch))
                df[0] = df[0] + (dot if dx else -dot) * (wy * wz)
                df[1] = df[1] + (dot if dy else -dot) * (wx * wz)
                df[2] = df[2] + (dot if dz else -dot) * (wx * wy)
    return df


def march_tiles_bwd_plain(gid, scal, t_o, t_d, t_mm, g_tiles, template, warp, dt, fadescale,
                          fadeexp, nbuf, counts: Optional[Dict[str, torch.Tensor]] = None,
                          state: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the backward kernel (csrc/mvp_march_bwd.cu):
    from the forward's saturation state (``state`` [NT, 8, T2]; when None, the
    forward march is run once more for it), per window the march's row sums
    and the rows' cotangents cscale_r and dL/da_r, then per candidate the
    samples' cotangents chained into the boxes and the affine. Arguments as
    for ``march_tiles_bwd``; returns (d_template [N*K, bs, bs, bs, 4], d_warp
    or None, d_affine [N*K, 12]). ``counts`` gets ``"forward_samples"`` (the
    samples marched for row sums, the march for a missing state included) and
    ``"chained_samples"``."""
    m = _TileMarch(gid, scal, t_o, t_d, t_mm, template, warp, dt, fadescale, fadeexp, nbuf)
    bs = m.bs
    d_tpl = torch.zeros_like(m.tpl)
    d_wrp = None if m.wrp is None else torch.zeros_like(m.wrp)
    d_aff = torch.zeros((template.shape[0], 12), dtype=m.dtype, device=m.dev)
    g = [g_tiles[:, j] for j in range(4)]  # [NT, T2]
    fwd_counts = None if counts is None else {}

    if state is None:
        _, state = march_tiles_plain(gid, scal, t_o, t_d, t_mm, template, warp, dt, fadescale,
                                     fadeexp, nbuf, counts=fwd_counts, with_state=True)
    a_s = state[:, 3]
    wsat = torch.where(
        a_s > 0.0,
        (g[0] * state[:, 0] + g[1] * state[:, 1] + g[2] * state[:, 2]) / torch.clamp(a_s, min=1e-12),
        torch.zeros_like(a_s))
    ga_qf = torch.where(state[:, 4] < 1.0, g[3], torch.zeros_like(a_s))

    cfade = -fadescale * fadeexp
    cum = torch.zeros_like(m.tmin)
    active = torch.ones(m.ntiles, dtype=torch.bool, device=m.dev)
    for w0, w1 in m.windows():
        acc, taken, _ = m.window_sums(w0, w1, active, taken=fwd_counts is not None)
        csc, da, marched = [], [], []
        for r in range(w1 - w0):
            marched.append(active)
            if fwd_counts is not None:
                fwd_counts["samples"] = fwd_counts.get("samples", 0) + taken[:, r][active].sum()
            a = acc[3][..., r]
            nw = cum + a
            am = torch.clamp(a, min=1e-12)
            cs_r = (torch.clamp(nw, max=1.0) - torch.clamp(cum, max=1.0)) / am
            w = (g[0] * acc[0][..., r] + g[1] * acc[1][..., r] + g[2] * acc[2][..., r]) / am
            rev = torch.where(nw < 1.0, w - wsat, torch.zeros_like(w))
            csc.append(cs_r)
            da.append((rev - cs_r * w) + ga_qf)
            cum = nw
            active = active & ~m.exits(cum, w0 + r)
        live_rows = torch.stack(marched, dim=-1)[:, None, :].to(m.dtype)  # [NT, 1, R]
        csc = torch.stack(csc, dim=-1) * live_rows  # [NT, T2, R]
        da = torch.stack(da, dim=-1) * live_rows
        for c in m.meeting(w0, w1, marched[0]):
            sp = m.samples(c, w0, w1)
            live = sp["mask"] & ((csc != 0.0) | (da != 0.0))
            if counts is not None:
                counts["chained_samples"] = counts.get("chained_samples", 0) + live.sum()
            livef = live.to(m.dtype)
            smp, u = sp["smp"], sp["u"] * livef
            dl = [g[j][..., None] * csc for j in range(3)]
            rgb_dot = dl[0] * smp[..., 0] + dl[1] * smp[..., 1] + dl[2] * smp[..., 2]
            alpha = smp[..., 3]
            dS = torch.stack([dl[0] * alpha * u, dl[1] * alpha * u, dl[2] * alpha * u,
                              (da + rgb_dot) * u], dim=-1).reshape(m.ntiles, -1, 4)
            g_u = (da + rgb_dot) * alpha
            gc = m.gid[:, c]
            df = _trilinear_bwd_plain(m.tpl[gc], d_tpl, gc, bs, *sp["f2"], dS)
            df = [torch.where(live.reshape(x.shape), x, 0.0) for x in df]
            if m.wrp is not None:
                dsw = torch.stack([x * m.half for x in df], dim=-1)
                df = _trilinear_bwd_plain(m.wrp[gc], d_wrp, gc, bs, *sp["f"], dsw)
            dfade = g_u * dt
            dyv = []
            for j in range(3):
                yj = sp["y"][j]
                inner = _pow_abs(yj, fadeexp - 1.0) * torch.sign(yj) if fadeexp != 1.0 \
                    else torch.sign(yj)
                fade_term = dfade * sp["fade"] * cfade * inner
                # masked samples may carry inf * 0 from far-away boxes
                dyv.append(torch.where(live, df[j].reshape(yj.shape) * m.half + fade_term,
                                       torch.zeros_like(yj)))
            pos = [m.o[i][..., None] + m.d[i][..., None] * sp["t"] for i in range(3)]
            terms = [torch.sum(pos[i] * dyv[j], dim=(1, 2)) for i in range(3) for j in range(3)]
            terms += [torch.sum(dyv[j], dim=(1, 2)) for j in range(3)]
            d_aff.index_add_(0, gc, torch.stack(terms, dim=-1))
        if not bool(active.any()):
            break
    if counts is not None:
        counts["forward_samples"] = fwd_counts.get("samples", 0)
    d_tpl = d_tpl.reshape(template.shape)
    return d_tpl, (None if d_wrp is None else d_wrp.reshape(warp.shape)), d_aff


def _check_tiles(gid, scal, t_o, t_d, t_mm, template, warp, state=None, **more) -> None:
    """What the kernels take: contiguous float32 tensors on the rays' device
    in the shapes of ``march_tiles``, the template table 16-byte aligned (its
    RGBA cells are read and added to as one vector each)."""
    ntiles, mh = gid.shape
    t2 = t_o.shape[2]
    bs = template.shape[1]
    dev = t_o.device
    f32 = dict(scal=scal, t_o=t_o, t_d=t_d, t_mm=t_mm, template=template, **more)
    if warp is not None:
        f32["warp"] = warp
    if state is not None:
        f32["state"] = state
    for name, x in f32.items():
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous float32 tensor on {dev}, got "
                             f"{x.dtype} on {x.device}")
    if gid.device != dev or gid.dtype != torch.int32 or not gid.is_contiguous():
        raise ValueError("gid: need a contiguous int32 tensor on the rays' device")
    if bs not in (2, 4, 8, 16) or template.shape[1:] != (bs, bs, bs, 4):
        raise ValueError(f"template must be [N*K, bs, bs, bs, 4] with bs in 2/4/8/16, "
                         f"got {tuple(template.shape)}")
    if template.data_ptr() % 16:
        raise ValueError("template: the table must start at a 16-byte aligned address "
                         f"(data_ptr() % 16 is {template.data_ptr() % 16})")
    if warp is not None and warp.shape != template.shape[:-1] + (3,):
        raise ValueError(f"warp must be {tuple(template.shape[:-1]) + (3,)}")
    if t2 % 32 or t2 > 1024 or t_o.shape != (ntiles, 3, t2) or t_d.shape != t_o.shape \
            or t_mm.shape != (ntiles, 2, t2) or scal.shape != (ntiles, mh, 12):
        raise ValueError("rays must be [NT, 3|2, T2] with T2 = tile^2 a multiple of 32 "
                         "and at most 1024, candidates [NT, MH(, 12)]")
    if state is not None and state.shape != (ntiles, STATE_ROWS, t2):
        raise ValueError(f"state must be {(ntiles, STATE_ROWS, t2)} (the forward's second "
                         f"output on these tiles), got {tuple(state.shape)}")


def _check_smem(smem: int, mh: int, t2: int, bs: int) -> None:
    if smem > _SMEM_LIMIT:
        raise ValueError(f"max_hit={mh} at {t2} rays per tile and primsize {bs} needs {smem} B "
                         f"of shared memory (limit {_SMEM_LIMIT})")


def _probe_counts(buf: torch.Tensor):
    """(warp trips, lanes entered, useful samples) triples of a probe buffer."""
    vals = [int(v) for v in buf.tolist()]
    return [tuple(vals[i:i + 3]) for i in range(0, len(vals), 3)]


class _MarchKernel:
    """Wrapper of the forward CUDA kernel with its launch count."""

    def __init__(self, cuda_lib: CudaLib):
        self.cuda_lib = cuda_lib
        self.launches = 0

    def _lib(self) -> ctypes.CDLL:
        lib = self.cuda_lib.lib()
        lib.mvp_march_fwd.restype = ctypes.c_int
        lib.mvp_march_fwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                                      + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        lib.mvp_march_fwd_smem_bytes.restype = ctypes.c_size_t
        lib.mvp_march_fwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        return lib

    def __call__(self, gid, scal, t_o, t_d, t_mm, template, warp, dt, fadescale, fadeexp,
                 nbuf, with_state: bool = False, probe: Optional[dict] = None):
        """``probe``, when given, runs the counting instance of the kernel and
        gets ``"march"``: (warp trips, lanes entered, useful samples)."""
        _check_tiles(gid, scal, t_o, t_d, t_mm, template, warp)
        ntiles, mh = gid.shape
        t2 = t_o.shape[2]
        bs = template.shape[1]
        dev = t_o.device
        lib = self._lib()
        _check_smem(lib.mvp_march_fwd_smem_bytes(t2, mh), mh, t2, bs)
        out = torch.empty((ntiles, 4, t2), dtype=torch.float32, device=dev)
        state = (torch.empty((ntiles, STATE_ROWS, t2), dtype=torch.float32, device=dev)
                 if with_state else None)
        tally = None if probe is None else torch.zeros(3, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = lib.mvp_march_fwd(
                gid.data_ptr(), scal.data_ptr(), t_o.data_ptr(), t_d.data_ptr(), t_mm.data_ptr(),
                template.data_ptr(), None if warp is None else warp.data_ptr(), out.data_ptr(),
                None if state is None else state.data_ptr(),
                None if tally is None else tally.data_ptr(),
                ntiles, t2, mh, bs, nbuf, dt, fadescale, fadeexp, stream)
        self.cuda_lib.check(err, "mvp_march_fwd launch")
        self.launches += 1
        if probe is not None:
            probe["march"], = _probe_counts(tally)
        return (out, state) if with_state else out


def fixed_point_bounds(g_tiles, scal, template, warp, dt, fadescale, fadeexp, nbuf,
                       state: Optional[torch.Tensor] = None):
    """Sound bounds of the sum of |addends| each channel group of the
    backward kernel's box tables receives, [5] float64 on the rays' device:
    the template's four channels, then the warp (0 without one), and the
    smallest density, whose sign the bounds assume (>= 0).

    R, A and the smallest density are taken over the template cells the
    march reads: from ``state``, the forward's (rows 5-7: each ray's
    extremes over the corners inside the box of the samples it took), or,
    without one, over the whole template. The backward marches the same
    windows, candidates and samples as the forward and reads no other cell
    (its row sums and its chain read the same corners), so the bound over
    the cells read is as sound as the one over the whole template, and a
    cell no sample reads (inf, or a negative density) cannot reach it.

    Per ray, with densities >= 0: the samples' cscale * alpha * u sum to at
    most 1 (the composite's weights) and cscale <= 1; |w|, |wsat| and
    |rgb_dot| are at most G = sum_c<3 |g_c| times R = max|rgb|; a trilinear
    weight set sums to at most 1 and its derivative along an axis to at most
    2. A ray's samples of one candidate lie on its chord through the box, at
    most chord / dt + 2 of them (and nbuf), where chord <= 2 sqrt(3) /
    sigma_min(A) and sigma_min(A) >= |det A| / (|A|_F^2 / 2); each has
    u <= dt * max fade. Summed over the tile's candidates that is the tile's
    U. So a ray adds at most |g_c| to rgb channel c, s3 = (4 G R + |g_a|) U
    to alpha, and 2 h D to the warp (h = (bs - 1) / 2), where D = R G + A s3
    bounds the template corners' dot products (A = max|alpha|)."""
    bs = template.shape[1]
    h = 0.5 * (bs - 1)
    g = g_tiles.double().abs()  # [NT, 4, T2]
    gsum = g[:, 0] + g[:, 1] + g[:, 2]  # [NT, T2]
    if state is None:
        lo, hi = torch.aminmax(template.reshape(-1, 4), dim=0)
        top = torch.maximum(lo.abs(), hi.abs()).double()
        rgb_max, alpha_max, alpha_min = top[:3].amax(), top[3], lo[3]
    else:
        rgb_max, alpha_max = state[:, 5].double().amax(), state[:, 6].double().amax()
        alpha_min = state[:, 7].amin()
    # samples a ray can take in each candidate, and their u summed per tile
    A = scal[..., :9].double().reshape(scal.shape[0], scal.shape[1], 3, 3)
    frob = (A * A).sum(dim=(-2, -1))
    det = (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
           - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
           + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))
    chord = 3.0**0.5 * frob / det.abs()  # inf for a singular A
    count = torch.clamp(chord / dt + 2.0, max=float(nbuf))
    count = torch.where(frob > 0, count, torch.zeros_like(count))  # A = 0: an empty slot
    fade_max = math.exp(3.0 * max(0.0, -fadescale))  # |y| <= 1 inside a box
    u = count.sum(dim=1, keepdim=True) * (dt * fade_max)  # [NT, 1]
    s3 = (4.0 * gsum * rgb_max + g[:, 3]) * u
    if warp is None:
        warp_bound = torch.zeros((), dtype=torch.float64, device=g.device)
    else:
        warp_bound = (2.0 * h * (rgb_max * gsum + alpha_max * s3)).sum()
    bounds = torch.stack([g[:, 0].sum(), g[:, 1].sum(), g[:, 2].sum(), s3.sum(), warp_bound])
    return bounds, alpha_min


def fixed_point_scales(g_tiles, scal, template, warp, state, dt, fadescale, fadeexp, nbuf):
    """The backward kernel's per-call scales [5] (the template's channels,
    then the warp's), from ``fixed_point_bounds`` over the cells the forward
    read (``state``); sets ``NEGATIVE_DENSITY`` in the device's fixed-point
    flag where one of them held a negative density. No host sync."""
    bounds, alpha_min = fixed_point_bounds(g_tiles, scal, template, warp, dt, fadescale,
                                           fadeexp, nbuf, state=state)
    flag = fixed_point.flag(g_tiles.device)
    flag.bitwise_or_((alpha_min < 0).to(torch.int32) * fixed_point.NEGATIVE_DENSITY)
    return fixed_point.scale_for(bounds)


class _MarchBwdKernel:
    """Wrapper of the backward CUDA kernel with its launch count;
    ``launches_with_state`` counts the launches that were handed the
    forward's saturation state (the others ran ``forward`` first for it)."""

    def __init__(self, cuda_lib: CudaLib, forward: _MarchKernel):
        self.cuda_lib = cuda_lib
        self.forward = forward
        self.launches = 0
        self.launches_with_state = 0

    def _lib(self) -> ctypes.CDLL:
        lib = self.cuda_lib.lib()
        lib.mvp_march_bwd.restype = ctypes.c_int
        lib.mvp_march_bwd.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 6
                                      + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        lib.mvp_march_bwd_smem_bytes.restype = ctypes.c_size_t
        lib.mvp_march_bwd_smem_bytes.argtypes = [ctypes.c_int] * 2
        return lib

    def __call__(self, gid, scal, t_o, t_d, t_mm, g_tiles, template, warp, dt, fadescale,
                 fadeexp, nbuf, counts: Optional[Dict[str, torch.Tensor]] = None,
                 state: Optional[torch.Tensor] = None, probe: Optional[dict] = None):
        """``counts``, when given, gets ``"forward_samples"`` (the samples this
        kernel marched for row sums) and ``"chained_samples"``; ``probe`` runs
        the counting instance and gets ``"march"`` and ``"chain"``: (warp
        trips, lanes entered, useful samples) each."""
        _check_tiles(gid, scal, t_o, t_d, t_mm, template, warp, state=state, g_tiles=g_tiles)
        ntiles, mh = gid.shape
        t2 = t_o.shape[2]
        bs = template.shape[1]
        nboxes = template.shape[0]
        dev = t_o.device
        if g_tiles.shape != (ntiles, 4, t2):
            raise ValueError(f"g_tiles must be {(ntiles, 4, t2)}, got {tuple(g_tiles.shape)}")
        lib = self._lib()
        _check_smem(lib.mvp_march_bwd_smem_bytes(t2, mh), mh, t2, bs)
        given = state is not None
        if not given:
            _, state = self.forward(gid, scal, t_o, t_d, t_mm, template, warp, dt, fadescale,
                                    fadeexp, nbuf, with_state=True)
        scales = fixed_point_scales(g_tiles, scal, template, warp, state, dt, fadescale, fadeexp,
                                    nbuf)
        flag = fixed_point.flag(dev)
        inv = 1.0 / scales
        inv_tmpl = inv[0:4].contiguous()
        inv_warp = inv[4:5].expand(3).contiguous()
        # integer box tables and the warps' affine rows: scratch from the
        # caching allocator
        q_tpl = torch.zeros(template.shape, dtype=torch.int64, device=dev)
        q_wrp = None if warp is None else torch.zeros(warp.shape, dtype=torch.int64, device=dev)
        rows = torch.zeros((ntiles, t2 // 32, mh, 12), dtype=torch.float32, device=dev)
        d_tpl = torch.empty_like(template)
        d_wrp = None if warp is None else torch.empty_like(warp)
        work = None if counts is None else torch.zeros(2, dtype=torch.int64, device=dev)
        tally = None if probe is None else torch.zeros(6, dtype=torch.int64, device=dev)
        ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = lib.mvp_march_bwd(
                gid.data_ptr(), scal.data_ptr(), t_o.data_ptr(), t_d.data_ptr(), t_mm.data_ptr(),
                g_tiles.data_ptr(), state.data_ptr(), template.data_ptr(), ptr(warp),
                q_tpl.data_ptr(), ptr(q_wrp), scales.data_ptr(), inv_tmpl.data_ptr(),
                inv_warp.data_ptr(), d_tpl.data_ptr(), ptr(d_wrp), rows.data_ptr(),
                flag.data_ptr(), ptr(work), ptr(tally),
                nboxes, ntiles, t2, mh, bs, nbuf, dt, fadescale, fadeexp, stream)
        self.cuda_lib.check(err, "mvp_march_bwd launch")
        self.launches += 1
        self.launches_with_state += int(given)
        if counts is not None:
            counts["forward_samples"], counts["chained_samples"] = work[0], work[1]
        if probe is not None:
            probe["march"], probe["chain"] = _probe_counts(tally)
        # over the warps in a fixed order, then over the tiles as integers
        return d_tpl, d_wrp, fixed_point.index_add_exact(
            nboxes, gid, rows.sum(dim=1).reshape(-1, 12))


march_tiles_kernel = _MarchKernel(MARCH_FWD_LIB)
march_tiles_bwd_kernel = _MarchBwdKernel(MARCH_BWD_LIB, march_tiles_kernel)
graphs.count_launches(march_tiles_kernel, "launches")
graphs.count_launches(march_tiles_bwd_kernel, "launches", "launches_with_state")


def _route(t_o: torch.Tensor, kernel, plain):
    """CUDA tensors go to the kernel, CPU tensors to its plain version."""
    if t_o.is_cuda:
        return kernel
    if t_o.device.type != "cpu":
        raise ValueError(f"no march for tensors on {t_o.device}")
    return plain


def march_tiles(gid, scal, t_o, t_d, t_mm, template, warp, dt, fadescale, fadeexp,
                nbuf, with_state: bool = False):
    """March and composite every tile. gid [NT, MH] int32 flat box index,
    scal [NT, MH, 12] candidate affines, t_o/t_d [NT, 3, T2], t_mm [NT, 2, T2],
    template [N*K, bs, bs, bs, 4], warp [N*K, bs, bs, bs, 3] or None.
    Returns [NT, 4, T2] RGBA, with ``with_state`` also the rays' state
    [NT, 8, T2] for ``march_tiles_bwd``. CUDA tensors go to the kernel,
    CPU tensors to its plain version."""
    return _route(t_o, march_tiles_kernel, march_tiles_plain)(
        gid, scal, t_o, t_d, t_mm, template, warp, dt, fadescale, fadeexp, nbuf,
        with_state=with_state)


def march_tiles_bwd(gid, scal, t_o, t_d, t_mm, g_tiles, template, warp, dt, fadescale,
                    fadeexp, nbuf, state: Optional[torch.Tensor] = None):
    """Backward of ``march_tiles``: g_tiles [NT, 4, T2] the cotangent of its
    output, state its second output on the same inputs (None: the forward is
    marched once more for it), the other arguments as there. Returns
    (d_template [N*K, bs, bs, bs, 4], d_warp [N*K, bs, bs, bs, 3] or None,
    d_affine [N*K, 12]: each primitive's dA row-major then db, summed over
    the tiles that hold it as a candidate). CUDA tensors go to the kernel,
    CPU tensors to its plain version."""
    if state is not None and not t_o.is_cuda:
        _check_tiles(gid, scal, t_o, t_d, t_mm, template, warp, state=state, g_tiles=g_tiles)
    return _route(t_o, march_tiles_bwd_kernel, march_tiles_bwd_plain)(
        gid, scal, t_o, t_d, t_mm, g_tiles, template, warp, dt, fadescale, fadeexp, nbuf,
        state=state)


# ---------------------------------------------------------------------------
# The op
# ---------------------------------------------------------------------------


def check_primsize(bs: int) -> None:
    if bs < 2 or bs & (bs - 1) or bs > 16:
        raise ValueError(f"the CUDA marcher takes a power-of-two primsize from 2 to 16 "
                         f"(the 262,144-prim bs=2 branch through the flagship's bs=8 and "
                         f"the 256-prim bs=16 one), got {bs}")


def on_device(x: torch.Tensor, device: torch.device) -> bool:
    return x.device.type == device.type and device.index in (None, x.device.index)


def resolve_device(device) -> torch.device:
    """torch.device for an entry point's ``device`` argument; CUDA must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the plain "
                           "PyTorch path on the CPU")
    return device


def default_nbuf(stepsize: float) -> int:
    """Step rows covering the [-1, 1]^3 cube diagonal."""
    return _ceil_to(int(2.0 * 3.0**0.5 / float(stepsize)) + 4, 8)


def affine_grads(primpos, primrot, primscale, d_aff):
    """The vjp of ``candidate_affines``' packing A = R diag(s), b = -c A:
    d_aff [N*K, 12] (dA row-major, then db) -> (d_primpos, d_primrot,
    d_primscale) in the inputs' shapes."""
    c = primpos.reshape(-1, 3)
    R = primrot.reshape(-1, 3, 3)
    sc = primscale.reshape(-1, 3)
    dA = d_aff[:, :9].reshape(-1, 3, 3)
    db = d_aff[:, 9:]
    A = R * sc[:, None, :]
    dA = dA - c[:, :, None] * db[:, None, :]
    d_pos = -torch.sum(A * db[:, None, :], dim=-1)
    d_rot = dA * sc[:, None, :]
    d_scale = torch.sum(dA * R, dim=-2)
    return (d_pos.reshape(primpos.shape), d_rot.reshape(primrot.shape),
            d_scale.reshape(primscale.shape))


class _Raymarch(torch.autograd.Function):
    """The differentiable op, as ``_make_raymarch`` of the JAX package:
    culling on the values only, the forward march, and the backward march
    with the forward's saved candidates and saturation state. Gradients flow to primpos, primrot,
    primscale, template and warp; rays, tminmax and prim_mask get none."""

    @staticmethod
    def forward(ctx, primpos, primrot, primscale, template, warp, raypos, raydir, tminmax,
                prim_mask, cfg):
        n, K = primpos.shape[:2]
        bs = template.shape[2]
        with annotate("ava:raymarch.cull"):
            t_o, t_d, t_mm, cand_gid, cand_valid, _, meta = tile_and_cull(
                raypos, raydir, tminmax, primpos, primscale, prim_mask, cfg["tile"],
                cfg["max_hit"], cfg["dt"], cull_group_size=cfg["cull_group_size"],
                cull_max_groups=cfg["cull_max_groups"], two_stage=cfg["two_stage_cull"])
        scal = candidate_affines(primpos, primrot, primscale, cand_gid, cand_valid)
        gid32 = cand_gid.to(torch.int32).contiguous()
        # the rays' saturation state is asked for only when a gradient will be
        need_state = any(ctx.needs_input_grad)
        res = march_tiles(
            gid32, scal, t_o, t_d, t_mm, template.reshape(n * K, bs, bs, bs, 4).contiguous(),
            None if warp is None else warp.reshape(n * K, bs, bs, bs, 3).contiguous(),
            cfg["dt"], cfg["fadescale"], cfg["fadeexp"], cfg["nbuf"], with_state=need_state)
        out, state = res if need_state else (res, None)
        # saved: the small culling results, the state and the inputs; the
        # candidate affines are rebuilt in the backward
        ctx.save_for_backward(t_o, t_d, t_mm, gid32, cand_valid, primpos, primrot, primscale,
                              template, warp, state)
        ctx.cfg, ctx.meta = cfg, meta
        return untile(out, meta, cfg["tile"])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (t_o, t_d, t_mm, gid32, cand_valid, primpos, primrot, primscale, template,
         warp, state) = ctx.saved_tensors
        cfg, meta = ctx.cfg, ctx.meta
        n, K = primpos.shape[:2]
        bs = template.shape[2]
        scal = candidate_affines(primpos, primrot, primscale, gid32.long(), cand_valid)
        # tile the cotangent like the forward's rays
        pad = (0, 0, 0, meta["wp"] - meta["w"], 0, meta["hp"] - meta["h"])
        g_tiles = tile_view(torch.nn.functional.pad(g, pad), cfg["tile"])
        d_tpl, d_wrp, d_aff = march_tiles_bwd(
            gid32, scal, t_o, t_d, t_mm, g_tiles,
            template.reshape(n * K, bs, bs, bs, 4).contiguous(),
            None if warp is None else warp.reshape(n * K, bs, bs, bs, 3).contiguous(),
            cfg["dt"], cfg["fadescale"], cfg["fadeexp"], cfg["nbuf"], state=state)
        d_pos, d_rot, d_scale = affine_grads(primpos, primrot, primscale, d_aff)
        return (d_pos, d_rot, d_scale, d_tpl.reshape(template.shape),
                None if d_wrp is None else d_wrp.reshape(warp.shape), None, None, None, None,
                None)


def mvp_raymarch_cuda(
    raypos: torch.Tensor,
    raydir: torch.Tensor,
    stepsize: float,
    tminmax: torch.Tensor,
    primpos: torch.Tensor,
    primrot: torch.Tensor,
    primscale: torch.Tensor,
    template: torch.Tensor,
    warp: Optional[torch.Tensor] = None,
    prim_mask: Optional[torch.Tensor] = None,
    fadescale: float = 8.0,
    fadeexp: float = 8.0,
    tile: int = 16,
    max_hit: int = 64,
    nbuf: Optional[int] = None,
    cull_group_size: int = 256,
    cull_max_groups: int = 8,
    two_stage_cull: Optional[bool] = None,
    device="cuda",
    **_unused,
) -> torch.Tensor:
    """Differentiable MVP raymarch, the counterpart of ``mvp_raymarch_pallas``.

    raypos/raydir [N, H, W, 3], tminmax [N, H, W, 2], primpos/primscale
    [N, K, 3], primrot [N, K, 3, 3] (or [N, K, 9]), template
    [N, K, bs, bs, bs, 4], warp [N, K, bs, bs, bs, 3] or None, prim_mask
    [N, K] (0 culls a primitive). Every tensor must lie on ``device``.
    ``nbuf`` (default: the cube diagonal) truncates the march at nbuf step
    rows. Returns RGBA [N, H, W, 4], differentiable in primpos,
    primrot, primscale, template and warp. Options of the Pallas op that only
    shape its TPU layout (rows, candidates, ...) are accepted and ignored.
    """
    with annotate("ava:raymarch"):
        device = resolve_device(device)
        tensors = [raypos, raydir, tminmax, primpos, primrot, primscale, template]
        tensors += [x for x in (warp, prim_mask) if x is not None]
        for x in tensors:
            if not on_device(x, device):
                raise ValueError(f"all inputs must be on {device}, got one on {x.device}")
        bs = template.shape[2]
        check_primsize(bs)
        if nbuf is None:
            nbuf = default_nbuf(stepsize)
        # the march holds nbuf step rows: a shorter range, never a wrong composite
        tmax = torch.minimum(tminmax[..., 1], tminmax[..., 0] + nbuf * float(stepsize))
        tminmax = torch.stack([tminmax[..., 0], tmax], dim=-1)
        n, K = primpos.shape[:2]
        if prim_mask is None:
            prim_mask = torch.ones((n, K), dtype=torch.float32, device=device)
        cfg = dict(dt=float(stepsize), fadescale=float(fadescale), fadeexp=float(fadeexp),
                   tile=int(tile), max_hit=int(max_hit), nbuf=int(nbuf),
                   cull_group_size=cull_group_size, cull_max_groups=cull_max_groups,
                   two_stage_cull=two_stage_cull)
        return _Raymarch.apply(primpos, primrot, primscale, template, warp, raypos, raydir, tminmax,
                               prim_mask.to(torch.float32), cfg)
