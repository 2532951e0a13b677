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
3. Its backward (``march_tiles_bwd``): from the cotangent of the composited
   tiles, the gradients of the template and warp boxes and of every
   primitive's affine, summed over the tiles. Kernel on CUDA tensors,
   ``march_tiles_bwd_plain`` on CPU tensors.
4. The op (``mvp_raymarch_cuda``): one ``torch.autograd.Function`` that culls
   on the values, marches, and in the backward re-marches with the forward's
   saved candidates; the affine gradients go on to primpos, primrot and
   primscale in PyTorch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from ava256_tpu_torch.ops.cuda_lib import CudaLib

MARCH_FWD_LIB = CudaLib("mvp_march_fwd.cu")
MARCH_BWD_LIB = CudaLib("mvp_march_bwd.cu")
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
WINDOW = 16  # step rows marched per window, as kWindow in the kernel


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


def tile_and_cull(raypos, raydir, tminmax, primpos, primscale, prim_mask, tile, max_hit, dt,
                  cull_group_size=256, cull_max_groups=8, two_stage=None):
    """Returns (t_o, t_d, t_mm [NT, C, T2], cand_gid [NT, MH] int64 into the
    flat N*K table, cand_valid [NT, MH], cand_tstart [NT, MH], meta)."""
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
        sel = tile_b[:, None] * G + gorder  # [NT, M] rows of the [N*G] group table
        centers = mem.reshape(n * G, g, 3)[sel].reshape(ntiles, M * g, 3)
        rads = mem_rad.reshape(n * G, g)[sel].reshape(ntiles, M * g)
        live_c = mem_live.reshape(n * G, g)[sel].reshape(ntiles, M * g) & torch.repeat_interleave(
            gvalid, g, dim=1)
        cand_local = order_s.reshape(n * G, g)[sel].reshape(ntiles, M * g)
        hit, t_start = _cone_test(centers, rads, live_c, *cone)
        key = torch.where(hit, t_start, math.inf)
        cand_tstart, order = _smallest(key, min(max_hit, key.shape[1]))
        cand_valid = torch.isfinite(cand_tstart)
        gids = tile_b[:, None] * K + torch.gather(cand_local, 1, order)
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


def _trilinear_plain(vol: torch.Tensor, bs: int, fx, fy, fz):
    """vol [NT, bs^3, C] (one box per tile), f* [NT, R] cell coordinates ->
    [NT, R, C]; corners outside the box read zero. Same sum order as the
    kernel's trilinear()."""
    x0, y0, z0 = torch.floor(fx), torch.floor(fy), torch.floor(fz)
    wx1, wy1, wz1 = fx - x0, fy - y0, fz - z0
    c = vol.shape[-1]
    out = 0.0
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
                out = out + vals * ok[..., None] * wgt[..., None]
    return out


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


class _TileMarch:
    """The tiles' inputs unpacked once, and the kernels' shared steps as
    PyTorch ops: one candidate's samples over a window of rows
    (``eval_sample`` in csrc/mvp_march_common.cuh) and a window's row sums
    (``march_window``)."""

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

    def windows(self):
        for w0 in range(self.rmin, self.rmax, WINDOW):
            yield w0, min(w0 + WINDOW, self.rmax)

    def meeting(self, w0, w1, active):
        """Candidate slots whose row range meets [w0, w1) in an active tile."""
        meets = ((self.r0 < w1) & (self.r1 > w0) & active[:, None]).any(dim=0)
        return torch.nonzero(meets).flatten().tolist()

    def samples(self, c, w0, w1):
        """Candidate slot c at rows [w0, w1): a dict of [NT, T2, R] tensors
        (t, y, fade, mask, u), the cell coordinates f (of y) and f2 (where the
        template is read), each [NT, T2 * R], and the template sample smp
        [NT, T2, R, 4]."""
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
        smp = _trilinear_plain(self.tpl[self.gid[:, c]], self.bs, *f2).reshape(
            self.ntiles, self.t2, -1, 4)
        return dict(t=t, y=y, fade=fade, mask=mask, u=u, f=f, f2=f2, smp=smp)

    def window_sums(self, w0, w1, active, counts=None):
        """[4, NT, T2, R]: rgb * a and a per row, summed over the candidates
        in candidate order."""
        acc = torch.zeros((4, self.ntiles, self.t2, w1 - w0), dtype=self.dtype, device=self.dev)
        for c in self.meeting(w0, w1, active):
            sp = self.samples(c, w0, w1)
            if counts is not None:
                live = (sp["mask"] & active[:, None, None]).sum()
                counts["samples"] = counts.get("samples", 0) + live
            a = sp["smp"][..., 3] * sp["u"]
            for j in range(3):
                acc[j] = acc[j] + sp["smp"][..., j] * a
            acc[3] = acc[3] + a
        return acc

    def done(self, cum, w1):
        """Rays that have saturated or can take no further sample."""
        return ((cum >= 1.0) | ~(self.tmin < self.tmax)
                | (self.tmin + float(w1) * self.dt >= self.tmax))


def march_tiles_plain(gid, scal, t_o, t_d, t_mm, template, warp, dt, fadescale, fadeexp,
                      nbuf, counts: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: the same per-tile march
    and composite, looping over windows of step rows and over candidates, and
    vectorized over tiles x rays x the rows of a window. Arguments as for
    ``march_tiles``; returns [NT, 4, T2]. ``counts``, when given, gets
    ``"samples"``: the (ray, row, candidate) samples the kernel evaluates on
    these inputs (the tiles' early exit included)."""
    m = _TileMarch(gid, scal, t_o, t_d, t_mm, template, warp, dt, fadescale, fadeexp, nbuf)
    cum = torch.zeros_like(m.tmin)
    rgb = [torch.zeros_like(m.tmin) for _ in range(3)]
    active = torch.ones(m.ntiles, dtype=torch.bool, device=m.dev)
    for w0, w1 in m.windows():
        acc = m.window_sums(w0, w1, active, counts)
        for r in range(w1 - w0):
            a = acc[3][..., r]
            nw = cum + a
            scale = (torch.clamp(nw, max=1.0) - torch.clamp(cum, max=1.0)) / torch.clamp(
                a, min=1e-12)
            keep = active[:, None]
            rgb = [torch.where(keep, rgb[j] + scale * acc[j][..., r], rgb[j]) for j in range(3)]
            cum = torch.where(keep, nw, cum)
        active = active & ~m.done(cum, w1).all(dim=1)
        if not bool(active.any()):
            break
    return torch.stack(rgb + [torch.clamp(cum, max=1.0)], dim=1)


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
                dot = torch.sum(vals * dS, dim=-1) * okf
                contrib = dS * (((wx * wy) * wz) * okf)[..., None]
                flat.index_add_(0, (gid_c[:, None] * cells + idx).reshape(-1),
                                contrib.reshape(-1, ch))
                df[0] = df[0] + (dot if dx else -dot) * (wy * wz)
                df[1] = df[1] + (dot if dy else -dot) * (wx * wz)
                df[2] = df[2] + (dot if dz else -dot) * (wx * wy)
    return df


def march_tiles_bwd_plain(gid, scal, t_o, t_d, t_mm, g_tiles, template, warp, dt, fadescale,
                          fadeexp, nbuf, counts: Optional[Dict[str, torch.Tensor]] = None):
    """Plain PyTorch version of the backward kernel (csrc/mvp_march_bwd.cu),
    pass by pass: (1) the forward march keeping each ray's saturation state,
    (2) per window the rows' cotangents cscale_r and dL/da_r, (3) per window
    and candidate the samples' cotangents chained into the boxes and the
    affine. Arguments as for ``march_tiles_bwd``; returns (d_template
    [N*K, bs, bs, bs, 4], d_warp or None, d_affine [N*K, 12]). ``counts``
    gets ``"forward_samples"`` (passes 1 and 2 together) and
    ``"chained_samples"`` (pass 3), as the kernel evaluates them."""
    m = _TileMarch(gid, scal, t_o, t_d, t_mm, template, warp, dt, fadescale, fadeexp, nbuf)
    bs = m.bs
    d_tpl = torch.zeros_like(m.tpl)
    d_wrp = None if m.wrp is None else torch.zeros_like(m.wrp)
    d_aff = torch.zeros((template.shape[0], 12), dtype=m.dtype, device=m.dev)
    g = [g_tiles[:, j] for j in range(4)]  # [NT, T2]
    fwd_counts = None if counts is None else {}

    # pass 1
    cum = torch.zeros_like(m.tmin)
    wsat = torch.zeros_like(m.tmin)
    active = torch.ones(m.ntiles, dtype=torch.bool, device=m.dev)
    w_end = torch.full((m.ntiles,), m.rmax, dtype=torch.int64, device=m.dev)
    for w0, w1 in m.windows():
        acc = m.window_sums(w0, w1, active, fwd_counts)
        for r in range(w1 - w0):
            a = acc[3][..., r]
            nw = cum + a
            w = (g[0] * acc[0][..., r] + g[1] * acc[1][..., r] + g[2] * acc[2][..., r]) \
                / torch.clamp(a, min=1e-12)
            keep = active[:, None]
            wsat = torch.where(keep & (cum < 1.0) & (nw >= 1.0), w, wsat)
            cum = torch.where(keep, nw, cum)
        stop = active & m.done(cum, w1).all(dim=1)
        w_end = torch.where(stop, torch.full_like(w_end, w1), w_end)
        active = active & ~stop
        if not bool(active.any()):
            break
    ga_qf = torch.where(cum < 1.0, g[3], torch.zeros_like(cum))

    # passes 2 and 3
    cfade = -fadescale * fadeexp
    cum = torch.zeros_like(m.tmin)
    for w0, w1 in m.windows():
        active = w_end > w0
        if not bool(active.any()):
            break
        acc = m.window_sums(w0, w1, active, fwd_counts)
        csc, da = [], []
        for r in range(w1 - w0):
            a = acc[3][..., r]
            nw = cum + a
            am = torch.clamp(a, min=1e-12)
            cs_r = (torch.clamp(nw, max=1.0) - torch.clamp(cum, max=1.0)) / am
            w = (g[0] * acc[0][..., r] + g[1] * acc[1][..., r] + g[2] * acc[2][..., r]) / am
            rev = torch.where(nw < 1.0, w - wsat, torch.zeros_like(w))
            csc.append(cs_r)
            da.append((rev - cs_r * w) + ga_qf)
            cum = nw
        live_tile = active[:, None, None].to(m.dtype)
        csc = torch.stack(csc, dim=-1) * live_tile  # [NT, T2, R]
        da = torch.stack(da, dim=-1) * live_tile
        for c in m.meeting(w0, w1, active):
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
    if counts is not None:
        counts["forward_samples"] = fwd_counts.get("samples", 0)
    d_tpl = d_tpl.reshape(template.shape)
    return d_tpl, (None if d_wrp is None else d_wrp.reshape(warp.shape)), d_aff


def _check_tiles(gid, scal, t_o, t_d, t_mm, template, warp, **more) -> None:
    """What the kernels take: contiguous float32 tensors on the rays' CUDA
    device in the shapes of ``march_tiles``."""
    ntiles, mh = gid.shape
    t2 = t_o.shape[2]
    bs = template.shape[1]
    dev = t_o.device
    f32 = dict(scal=scal, t_o=t_o, t_d=t_d, t_mm=t_mm, template=template, **more)
    if warp is not None:
        f32["warp"] = warp
    for name, x in f32.items():
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous float32 tensor on {dev}, got "
                             f"{x.dtype} on {x.device}")
    if gid.device != dev or gid.dtype != torch.int32 or not gid.is_contiguous():
        raise ValueError("gid: need a contiguous int32 tensor on the rays' device")
    if bs not in (2, 4, 8, 16) or template.shape[1:] != (bs, bs, bs, 4):
        raise ValueError(f"template must be [N*K, bs, bs, bs, 4] with bs in 2/4/8/16, "
                         f"got {tuple(template.shape)}")
    if warp is not None and warp.shape != template.shape[:-1] + (3,):
        raise ValueError(f"warp must be {tuple(template.shape[:-1]) + (3,)}")
    if t2 % 32 or t2 > 1024 or t_o.shape != (ntiles, 3, t2) or t_d.shape != t_o.shape \
            or t_mm.shape != (ntiles, 2, t2) or scal.shape != (ntiles, mh, 12):
        raise ValueError("rays must be [NT, 3|2, T2] with T2 = tile^2 a multiple of 32 "
                         "and at most 1024, candidates [NT, MH(, 12)]")


def _check_smem(smem: int, mh: int, t2: int, bs: int) -> None:
    if smem > _SMEM_LIMIT:
        raise ValueError(f"max_hit={mh} at {t2} rays per tile and primsize {bs} needs {smem} B "
                         f"of shared memory (limit {_SMEM_LIMIT})")


class _MarchKernel:
    """Wrapper of the forward CUDA kernel with its launch count."""

    def __init__(self):
        self.launches = 0

    @staticmethod
    def _lib() -> ctypes.CDLL:
        lib = MARCH_FWD_LIB.lib()
        lib.mvp_march_fwd.restype = ctypes.c_int
        lib.mvp_march_fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                                      + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        lib.mvp_march_fwd_smem_bytes.restype = ctypes.c_size_t
        lib.mvp_march_fwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        return lib

    def __call__(self, gid, scal, t_o, t_d, t_mm, template, warp, dt, fadescale, fadeexp,
                 nbuf) -> torch.Tensor:
        _check_tiles(gid, scal, t_o, t_d, t_mm, template, warp)
        ntiles, mh = gid.shape
        t2 = t_o.shape[2]
        bs = template.shape[1]
        dev = t_o.device
        lib = self._lib()
        _check_smem(lib.mvp_march_fwd_smem_bytes(t2, mh), mh, t2, bs)
        out = torch.empty((ntiles, 4, t2), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = lib.mvp_march_fwd(gid.data_ptr(), scal.data_ptr(), t_o.data_ptr(), t_d.data_ptr(),
                     t_mm.data_ptr(), template.data_ptr(),
                     None if warp is None else warp.data_ptr(), out.data_ptr(),
                     ntiles, t2, mh, bs, nbuf, dt, fadescale, fadeexp, stream)
        MARCH_FWD_LIB.check(err, "mvp_march_fwd launch")
        self.launches += 1
        return out


class _MarchBwdKernel:
    """Wrapper of the backward CUDA kernel with its launch count."""

    def __init__(self):
        self.launches = 0

    @staticmethod
    def _lib() -> ctypes.CDLL:
        lib = MARCH_BWD_LIB.lib()
        lib.mvp_march_bwd.restype = ctypes.c_int
        lib.mvp_march_bwd.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                                      + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        lib.mvp_march_bwd_smem_bytes.restype = ctypes.c_size_t
        lib.mvp_march_bwd_smem_bytes.argtypes = [ctypes.c_int] * 2
        return lib

    def __call__(self, gid, scal, t_o, t_d, t_mm, g_tiles, template, warp, dt, fadescale,
                 fadeexp, nbuf, counts: Optional[Dict[str, torch.Tensor]] = None):
        """``counts``, when given, gets ``"forward_samples"`` and
        ``"chained_samples"`` as ``march_tiles_bwd_plain`` counts them."""
        _check_tiles(gid, scal, t_o, t_d, t_mm, template, warp, g_tiles=g_tiles)
        ntiles, mh = gid.shape
        t2 = t_o.shape[2]
        bs = template.shape[1]
        dev = t_o.device
        if g_tiles.shape != (ntiles, 4, t2):
            raise ValueError(f"g_tiles must be {(ntiles, 4, t2)}, got {tuple(g_tiles.shape)}")
        lib = self._lib()
        _check_smem(lib.mvp_march_bwd_smem_bytes(t2, mh), mh, t2, bs)
        d_tpl = torch.zeros_like(template)
        d_wrp = None if warp is None else torch.zeros_like(warp)
        d_aff = torch.zeros((template.shape[0], 12), dtype=torch.float32, device=dev)
        work = None if counts is None else torch.zeros(2, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = lib.mvp_march_bwd(
                gid.data_ptr(), scal.data_ptr(), t_o.data_ptr(), t_d.data_ptr(), t_mm.data_ptr(),
                g_tiles.data_ptr(), template.data_ptr(),
                None if warp is None else warp.data_ptr(), d_tpl.data_ptr(),
                None if d_wrp is None else d_wrp.data_ptr(), d_aff.data_ptr(),
                None if work is None else work.data_ptr(), ntiles, t2, mh, bs, nbuf, dt, fadescale, fadeexp, stream)
        MARCH_BWD_LIB.check(err, "mvp_march_bwd launch")
        self.launches += 1
        if counts is not None:
            counts["forward_samples"], counts["chained_samples"] = work[0], work[1]
        return d_tpl, d_wrp, d_aff


march_tiles_kernel = _MarchKernel()
march_tiles_bwd_kernel = _MarchBwdKernel()


def _route(t_o: torch.Tensor, kernel, plain):
    """CUDA tensors go to the kernel, CPU tensors to its plain version."""
    if t_o.is_cuda:
        return kernel
    if t_o.device.type != "cpu":
        raise ValueError(f"no march for tensors on {t_o.device}")
    return plain


def march_tiles(gid, scal, t_o, t_d, t_mm, template, warp, dt, fadescale, fadeexp,
                nbuf) -> torch.Tensor:
    """March and composite every tile. gid [NT, MH] int32 flat box index,
    scal [NT, MH, 12] candidate affines, t_o/t_d [NT, 3, T2], t_mm [NT, 2, T2],
    template [N*K, bs, bs, bs, 4], warp [N*K, bs, bs, bs, 3] or None.
    Returns [NT, 4, T2] RGBA. CUDA tensors go to the kernel, CPU tensors to
    its plain version."""
    return _route(t_o, march_tiles_kernel, march_tiles_plain)(
        gid, scal, t_o, t_d, t_mm, template, warp, dt, fadescale, fadeexp, nbuf)


def march_tiles_bwd(gid, scal, t_o, t_d, t_mm, g_tiles, template, warp, dt, fadescale,
                    fadeexp, nbuf):
    """Backward of ``march_tiles``: g_tiles [NT, 4, T2] the cotangent of its
    output, the other arguments as there. Returns (d_template
    [N*K, bs, bs, bs, 4], d_warp [N*K, bs, bs, bs, 3] or None, d_affine
    [N*K, 12]: each primitive's dA row-major then db, summed over the tiles
    that hold it as a candidate). CUDA tensors go to the kernel, CPU tensors
    to its plain version."""
    return _route(t_o, march_tiles_bwd_kernel, march_tiles_bwd_plain)(
        gid, scal, t_o, t_d, t_mm, g_tiles, template, warp, dt, fadescale, fadeexp, nbuf)


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
    with the forward's saved candidates. Gradients flow to primpos, primrot,
    primscale, template and warp; rays, tminmax and prim_mask get none."""

    @staticmethod
    def forward(ctx, primpos, primrot, primscale, template, warp, raypos, raydir, tminmax,
                prim_mask, cfg):
        n, K = primpos.shape[:2]
        bs = template.shape[2]
        t_o, t_d, t_mm, cand_gid, cand_valid, _, meta = tile_and_cull(
            raypos, raydir, tminmax, primpos, primscale, prim_mask, cfg["tile"], cfg["max_hit"],
            cfg["dt"], cull_group_size=cfg["cull_group_size"],
            cull_max_groups=cfg["cull_max_groups"], two_stage=cfg["two_stage_cull"])
        scal = candidate_affines(primpos, primrot, primscale, cand_gid, cand_valid)
        gid32 = cand_gid.to(torch.int32).contiguous()
        out = march_tiles(
            gid32, scal, t_o, t_d, t_mm, template.reshape(n * K, bs, bs, bs, 4).contiguous(),
            None if warp is None else warp.reshape(n * K, bs, bs, bs, 3).contiguous(),
            cfg["dt"], cfg["fadescale"], cfg["fadeexp"], cfg["nbuf"])
        # saved: the small culling results and the inputs; the candidate
        # affines are rebuilt in the backward
        ctx.save_for_backward(t_o, t_d, t_mm, gid32, cand_valid, primpos, primrot, primscale,
                              template, warp)
        ctx.cfg, ctx.meta = cfg, meta
        return untile(out, meta, cfg["tile"])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (t_o, t_d, t_mm, gid32, cand_valid, primpos, primrot, primscale, template,
         warp) = ctx.saved_tensors
        cfg, meta = ctx.cfg, ctx.meta
        n, K = primpos.shape[:2]
        bs = template.shape[2]
        scal = candidate_affines(primpos, primrot, primscale, gid32.long(), cand_valid)
        # tile the cotangent like the forward's rays
        pad = (0, 0, 0, meta["wp"] - meta["w"], 0, meta["hp"] - meta["h"])
        g_tiles = tile_view(torch.nn.functional.pad(g.to(torch.float32), pad), cfg["tile"])
        d_tpl, d_wrp, d_aff = march_tiles_bwd(
            gid32, scal, t_o, t_d, t_mm, g_tiles,
            template.reshape(n * K, bs, bs, bs, 4).contiguous(),
            None if warp is None else warp.reshape(n * K, bs, bs, bs, 3).contiguous(),
            cfg["dt"], cfg["fadescale"], cfg["fadeexp"], cfg["nbuf"])
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
    tminmax = torch.stack(
        [tminmax[..., 0], torch.minimum(tminmax[..., 1], tminmax[..., 0] + nbuf * float(stepsize))],
        dim=-1)
    n, K = primpos.shape[:2]
    if prim_mask is None:
        prim_mask = torch.ones((n, K), dtype=torch.float32, device=device)
    cfg = dict(dt=float(stepsize), fadescale=float(fadescale), fadeexp=float(fadeexp),
               tile=int(tile), max_hit=int(max_hit), nbuf=int(nbuf),
               cull_group_size=cull_group_size, cull_max_groups=cull_max_groups,
               two_stage_cull=two_stage_cull)
    return _Raymarch.apply(primpos, primrot, primscale, template, warp, raypos, raydir, tminmax,
                           prim_mask.to(torch.float32), cfg)
