# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Compacted MVP raymarcher in plain PyTorch, the port of
``ava256_tpu.ops.raymarch_xla`` (XLA code there, so PyTorch tensor ops
differentiated by autograd here; no kernel of its own). It is the
``model.raymarch.backend: xla`` of the configs, and an independent check of
the CUDA kernels on the card (``kbench --verify``, ``chip_smoke.py``).

1. **Tile culling**: rays are grouped into tile x tile pixel tiles (the rays
   of one camera share an origin, so a tile is a cone); each primitive's
   bounding sphere is tested against each tile's cone, and the nearest
   ``max_hit`` hits are kept, nearest first (ties by lower index, the order
   ``jax.lax.top_k`` gives).
2. **Per-ray refinement**: exact ray/box slab tests against the tile's
   candidates give per-ray [t_in, t_out) intervals.
3. **Sample compaction**: each ray enumerates at most ``max_samples`` samples
   t = tmin + k * dt inside its intervals, sorted by t with a stable sort:
   samples of overlapping primitives share the ray's grid of times, and on a
   tie the nearer candidate comes first. Rays that need more samples drop
   their farthest; ``on_overflow`` chooses between a warning ("warn") and
   NaN in the whole output ("error").
4. **Evaluation and saturating scan**: each sample goes into its primitive's
   frame, gets the border fade and a trilinear RGBA sample (align_corners),
   and the sorted samples are composited by the reference's rule
       m_j = min(cumsum(alpha)_j, 1); contrib_j = m_j - m_{j-1}
       rgb = sum_j contrib_j * rgb_j;  alpha = m_last.

Tiles are marched in chunks of ``chunk_tiles``, each under activation
checkpointing (``ops.layers.remat``) as ``jax.checkpoint`` does there. The
culling, the slab tests and the sort only choose indices and take no
gradient; the samples' evaluation carries the gradients of primpos, primrot,
primscale, template and warp.
"""

from __future__ import annotations

import logging
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ava256_tpu_torch.ops import fixed_point
from ava256_tpu_torch.ops.layers import remat
from ava256_tpu_torch.ops.raymarch_cuda import _norm, _smallest

logger = logging.getLogger(__name__)

# the options mvp_raymarch_xla takes beyond the scene; the configs' other
# raymarch keys (rows, nbuf, the cull's groups) shape the kernels only
OPTIONS = frozenset({"tile", "max_hit", "max_samples", "chunk_tiles", "on_overflow"})


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _cummax(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cummax(x, dim=dim).values


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last dim by log2 shifted adds: a fixed
    tree of the same terms on every run and device (a float ``torch.cumsum``
    has no deterministic form on CUDA)."""
    d = 1
    while d < x.shape[-1]:
        x = x + F.pad(x[..., :-d], (d, 0))
        d *= 2
    return x


class _Take(torch.autograd.Function):
    """table[idx] as an index_select whose backward is an order-free integer
    index_add (``fixed_point.index_add_exact``): the same bits on every run,
    where index_select's own backward adds with float atomics (or, under the
    deterministic mode, sorts: seconds a step on an H100)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return torch.index_select(table, 0, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        return fixed_point.index_add_exact(ctx.rows, idx, grad), None


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx], differentiable in table with a deterministic backward."""
    return _Take.apply(table, idx.reshape(-1)).reshape(idx.shape + table.shape[1:])


def _trilinear(flat_template: torch.Tensor, vol_shape: Tuple[int, int, int],
               gid: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """align_corners=True trilinear sampling with zero padding, batched by a
    per-sample volume id: flat_template [(N*K)*D*H*W, C], gid [...] the
    volume of each sample (b * K + k), y [..., 3] coordinates in [-1, 1]
    (x -> W, y -> H, z -> D). Returns [..., C]: 8 corner gathers."""
    d, h, w = vol_shape
    fx = (y[..., 0] + 1.0) * 0.5 * (w - 1)
    fy = (y[..., 1] + 1.0) * 0.5 * (h - 1)
    fz = (y[..., 2] + 1.0) * 0.5 * (d - 1)
    x0, y0, z0 = torch.floor(fx), torch.floor(fy), torch.floor(fz)
    wx1, wy1, wz1 = fx - x0, fy - y0, fz - z0

    base = gid.long() * (d * h * w)
    idx, masks, wgts = [], [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi, zi = x0 + dx, y0 + dy, z0 + dz
                masks.append((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
                             & (zi >= 0) & (zi <= d - 1))
                xc = torch.clamp(xi, 0, w - 1).long()
                yc = torch.clamp(yi, 0, h - 1).long()
                zc = torch.clamp(zi, 0, d - 1).long()
                idx.append(base + (zc * h + yc) * w + xc)
                wgts.append((wx1 if dx else 1.0 - wx1) * (wy1 if dy else 1.0 - wy1)
                            * (wz1 if dz else 1.0 - wz1))
    # one gather of the 8 corners: one table-sized gradient per call, not 8
    vals = _take(flat_template, torch.stack(idx, dim=-1))  # [..., 8, C]
    out = 0.0
    for k in range(8):
        out = out + (vals[..., k, :] * masks[k][..., None]) * wgts[k][..., None]
    return out


def _matvec(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x [..., 3] @ m [..., 3, 3] (row vector times matrix)."""
    return torch.sum(x[..., :, None] * m, dim=-2)


def cull_tiles(raypos, raydir, tminmax, primpos, primscale, tile: int, max_hit: int,
               dt: float):
    """Tile the rays and cull the primitives per tile (values only, no
    gradient). Returns (t_o, t_d [NT, T2, 3], t_mm [NT, T2, 2], cand_gid
    [NT, MH] into the flat N*K table, cand_valid [NT, MH], (nty, ntx)); a
    tile with all MH candidates valid may have lost hits beyond max_hit."""
    n, h, w = raypos.shape[0], raypos.shape[1], raypos.shape[2]
    K = primpos.shape[1]
    # pad the image to whole tiles; dead rays get empty t-ranges
    hp, wp = _ceil_to(h, tile), _ceil_to(w, tile)
    pad = (0, 0, 0, wp - w, 0, hp - h)
    nty, ntx = hp // tile, wp // tile
    ntiles = n * nty * ntx

    def tile_view(x):
        ch = x.shape[-1]
        x = x.reshape(n, nty, tile, ntx, tile, ch)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(ntiles, tile * tile, ch)

    with torch.no_grad():
        t_o = tile_view(F.pad(raypos, pad))  # [NT, T2, 3]
        t_d = tile_view(F.pad(raydir, pad, value=1.0))
        t_mm = tile_view(F.pad(tminmax, pad, value=0.0))  # tmin = tmax = 0: dead
        tile_b = torch.arange(ntiles, device=raypos.device) // (nty * ntx)  # batch of a tile

        # the tile's cone: all rays of a camera share an origin
        radii = _norm(1.0 / primscale)  # [N, K]: circumradius of the local box
        apex = t_o[:, 0, :]  # [NT, 3]
        dsum = torch.sum(t_d, dim=1)
        axis = dsum / _norm(dsum)[:, None]
        cosmin = torch.amin(torch.sum(t_d * axis[:, None, :], dim=-1), dim=1)
        sinmax = torch.sqrt(torch.clamp(1.0 - cosmin**2, 0.0, 1.0))
        tanmax = sinmax / torch.clamp(cosmin, min=1e-3)  # [NT]
        live = t_mm[..., 0] < t_mm[..., 1]
        big = 1e9
        tile_tmin = torch.amin(torch.where(live, t_mm[..., 0], big), dim=1)
        tile_tmax = torch.amax(torch.where(live, t_mm[..., 1], -big), dim=1)

        v = primpos[tile_b] - apex[:, None, :]  # [NT, K, 3]
        rads = radii[tile_b]
        t_c = torch.sum(v * axis[:, None, :], dim=-1)
        dist = _norm(v - t_c[..., None] * axis[:, None, :])
        hit = ((dist <= rads + torch.clamp(t_c, min=0.0) * tanmax[:, None] + dt)
               & (t_c + rads >= tile_tmin[:, None])
               & (t_c - rads <= tile_tmax[:, None])
               & (tile_tmax > tile_tmin)[:, None])
        del v, dist
        key = torch.where(hit, t_c, math.inf)
        cand_key, order = _smallest(key, min(max_hit, K))  # [NT, MH] nearest first
        cand_valid = torch.isfinite(cand_key)
        cand_gid = tile_b[:, None] * K + order  # global primitive ids
    return t_o, t_d, t_mm, cand_gid, cand_valid, (nty, ntx)


def march_compacted(
    raypos: torch.Tensor,
    raydir: torch.Tensor,
    stepsize: float,
    tminmax: torch.Tensor,
    primpos: torch.Tensor,
    primrot: torch.Tensor,
    primscale: torch.Tensor,
    template: torch.Tensor,
    warp: Optional[torch.Tensor] = None,
    fadescale: float = 8.0,
    fadeexp: float = 8.0,
    tile: int = 16,
    max_hit: int = 128,
    max_samples: int = 128,
    chunk_tiles: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The march of ``mvp_raymarch_xla`` without its overflow policy:
    returns (rayrgba [N, H, W, 4], the number of rays that needed more than
    ``max_samples`` samples, a 0-d int64 tensor on the rays' device)."""
    n, h, w = raypos.shape[0], raypos.shape[1], raypos.shape[2]
    K = primpos.shape[1]
    vd, vh, vw = template.shape[2], template.shape[3], template.shape[4]
    dt = float(stepsize)
    dev = raypos.device
    out_dtype = raypos.dtype
    t_o, t_d, t_mm, cand_gid, cand_valid, (nty, ntx) = cull_tiles(
        raypos, raydir, tminmax, primpos, primscale, tile, max_hit, dt)

    # primitives flattened over the batch for global gathers
    fp_pos = primpos.reshape(n * K, 3)
    fp_rot = primrot.reshape(n * K, 3, 3)
    fp_scale = primscale.reshape(n * K, 3)
    flat_template = template.reshape(-1, template.shape[-1])
    flat_warp = None if warp is None else warp.reshape(-1, warp.shape[-1])

    def process(o, d, mm, gid, cvalid):
        # o, d: [CT, T2, 3]; mm: [CT, T2, 2]; gid, cvalid: [CT, MH]
        ct, t2, mh = o.shape[0], o.shape[1], gid.shape[1]
        tmin, tmax = mm[..., 0], mm[..., 1]
        with torch.no_grad():
            c_pos, c_rot, c_scale = fp_pos[gid], fp_rot[gid], fp_scale[gid]
            # exact ray/box slab tests in the primitives' frames
            rel = o[:, None, :, :] - c_pos[:, :, None, :]  # [CT, MH, T2, 3]
            oy = _matvec(rel, c_rot[:, :, None]) * c_scale[:, :, None, :]
            dy = _matvec(d[:, None], c_rot[:, :, None]) * c_scale[:, :, None, :]
            dy = torch.where(torch.abs(dy) < 1e-9, torch.where(dy >= 0, 1e-9, -1e-9), dy)
            t1 = (-1.0 - oy) / dy
            t2_ = (1.0 - oy) / dy
            tin = torch.amax(torch.minimum(t1, t2_), dim=-1)  # [CT, MH, T2]
            tout = torch.amin(torch.maximum(t1, t2_), dim=-1)
            del rel, oy, dy, t1, t2_
            tin = torch.maximum(tin, tmin[:, None, :])
            tout = torch.minimum(tout, tmax[:, None, :])
            seg_ok = (tin < tout) & cvalid[:, :, None]

            # steps of the ray's grid t = tmin + k dt that meet [tin, tout),
            # widened by one step on each side (the in-box mask is exact)
            kin = torch.clamp(torch.floor((tin - tmin[:, None, :]) / dt) - 1.0, min=0.0)
            cnt_raw = torch.ceil((tout - tmin[:, None, :]) / dt) - kin + 1.0
            cnt_raw = torch.where(seg_ok, torch.clamp(cnt_raw, min=0.0), 0.0)
            # rays whose candidates ask for more samples than the budget drop
            # their farthest; counted for the caller
            n_overflow = torch.sum(torch.sum(cnt_raw, dim=1) > float(max_samples))
            cnt = torch.clamp(cnt_raw, 0.0, float(max_samples))
            kin = kin.long().transpose(1, 2)  # [CT, T2, MH]
            cnt = cnt.long().transpose(1, 2)

            # each candidate's first slot in the ray's sample list
            off = torch.cumsum(cnt, dim=-1) - cnt
            # slot -> candidate: scatter-max of each candidate at its first
            # slot, then a running max; candidates starting past the list go
            # to an extra slot that is cut off (JAX drops them)
            hvals = torch.arange(mh, device=dev).expand(ct, t2, mh)
            scat = torch.where(cnt > 0, hvals, 0)
            first = torch.where((cnt > 0) & (off < max_samples), off, max_samples)
            slot = torch.zeros((ct, t2, max_samples + 1), dtype=torch.long, device=dev)
            slot.scatter_reduce_(-1, first, scat, reduce="amax", include_self=True)
            cand_of = _cummax(slot[..., :max_samples], dim=-1)  # [CT, T2, S]

            j = torch.arange(max_samples, device=dev)
            off_j = torch.gather(off, -1, cand_of)
            cnt_j = torch.gather(cnt, -1, cand_of)
            kin_j = torch.gather(kin, -1, cand_of)
            s_valid = (j - off_j) < cnt_j
            t_j = tmin[..., None] + (kin_j + (j - off_j)).to(out_dtype) * dt
            s_valid &= (t_j >= tmin[..., None]) & (t_j < tmax[..., None])

            # global t order; the stable sort keeps the near-to-far candidate
            # order on ties
            t_sortkey = torch.where(s_valid, t_j, math.inf)
            sort_idx = torch.argsort(t_sortkey, dim=-1, stable=True)
            t_j = torch.gather(t_j, -1, sort_idx)
            s_valid = torch.gather(s_valid, -1, sort_idx)
            cand_of = torch.gather(cand_of, -1, sort_idx)
            g_j = torch.gather(gid[:, None, :].expand(ct, t2, mh), -1, cand_of)
            g_safe = torch.where(s_valid, g_j, 0)
            # an unused slot of a ray that misses its candidates takes a
            # candidate's kin, which a ray parallel to a box face puts ~1e9/dt
            # away: at such t, |y|^fadeexp overflows and its zero gradient
            # becomes NaN (0 * inf) in every primitive's. Unused slots sit at
            # tmin (JAX keeps the far time, and its gradients go NaN there).
            t_j = torch.where(s_valid, t_j, tmin[..., None])

        # the samples, differentiable in the primitives and their volumes
        pos = o[:, :, None, :] + d[:, :, None, :] * t_j[..., None]
        p_pos, p_rot, p_scale = (_take(x, g_safe) for x in (fp_pos, fp_rot, fp_scale))
        y0 = _matvec(pos - p_pos, p_rot) * p_scale  # [CT, T2, S, 3]
        fade = torch.exp(-fadescale * torch.sum(torch.abs(y0) ** fadeexp, dim=-1))
        inbox = torch.all((y0 >= -1.0) & (y0 <= 1.0), dim=-1)
        y1 = y0 if flat_warp is None else _trilinear(flat_warp, (vd, vh, vw), g_safe, y0)
        sample = _trilinear(flat_template, (vd, vh, vw), g_safe, y1)

        mask = (s_valid & inbox).to(out_dtype)
        alpha_j = sample[..., 3] * fade * dt * mask  # [CT, T2, S]
        cum = _prefix_sum(alpha_j)
        cum_prev = F.pad(cum[..., :-1], (1, 0))
        m = torch.clamp(cum, max=1.0)
        # contrib_j = m_j - m_{j-1}; before saturation that is alpha_j itself,
        # taken as it is: the difference of two running sums near 1 would
        # round each sample's share to fp32's step at 1 (up to ~5e-4 of a
        # pixel over a thousand samples)
        contrib = torch.where((cum <= 1.0) & (cum_prev <= 1.0), alpha_j,
                              m - torch.clamp(cum_prev, max=1.0))
        rgb = torch.sum(contrib[..., None] * sample[..., 0:3], dim=-2)  # [CT, T2, 3]
        return torch.cat([rgb, m[..., -1:]], dim=-1), n_overflow

    outs, overflow = [], []
    for c0 in range(0, t_o.shape[0], chunk_tiles):
        sl = slice(c0, c0 + chunk_tiles)
        out, n_over = remat(process, t_o[sl], t_d[sl], t_mm[sl], cand_gid[sl], cand_valid[sl])
        outs.append(out)
        overflow.append(n_over)
    out = torch.cat(outs)  # [NT, T2, 4]

    # un-tile and crop the padding
    out = out.reshape(n, nty, ntx, tile, tile, 4).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(n, nty * tile, ntx * tile, 4)[:, :h, :w, :]
    return out, torch.stack(overflow).sum()


def mvp_raymarch_xla(
    raypos: torch.Tensor,
    raydir: torch.Tensor,
    stepsize: float,
    tminmax: torch.Tensor,
    primpos: torch.Tensor,
    primrot: torch.Tensor,
    primscale: torch.Tensor,
    template: torch.Tensor,
    warp: Optional[torch.Tensor] = None,
    fadescale: float = 8.0,
    fadeexp: float = 8.0,
    tile: int = 16,
    max_hit: int = 128,
    max_samples: int = 128,
    chunk_tiles: int = 64,
    on_overflow: str = "warn",
) -> torch.Tensor:
    """Differentiable compacted MVP raymarch, as ``mvp_raymarch_xla`` of the
    JAX package, on the inputs' device.

    raypos/raydir [N, H, W, 3], tminmax [N, H, W, 2], primpos/primscale
    [N, K, 3], primrot [N, K, 3, 3] (columns are the local axes), template
    [N, K, D, H', W', 4], warp [N, K, D, H', W', 3] or None. Returns RGBA
    [N, H, W, 4], differentiable in primpos, primrot, primscale, template and
    warp.

    ``max_samples`` is a budget per ray: a ray that needs more drops its
    farthest samples, a different (darker) result. ``on_overflow="error"``
    then puts NaN in the whole output, on the device, without a host sync;
    ``"warn"`` logs a warning with the count of such rays, which costs one
    host sync (``.item()``) per call.
    """
    if on_overflow not in ("warn", "error"):
        raise ValueError(f"on_overflow must be 'warn' or 'error', got {on_overflow!r}")
    out, overflow = march_compacted(
        raypos, raydir, stepsize, tminmax, primpos, primrot, primscale, template, warp,
        fadescale=fadescale, fadeexp=fadeexp, tile=tile, max_hit=max_hit,
        max_samples=max_samples, chunk_tiles=chunk_tiles)
    if on_overflow == "error":
        return torch.where(overflow > 0, torch.full_like(out, math.nan), out)
    count = int(overflow.item())
    if count:
        logger.warning("mvp_raymarch_xla: %d rays exceeded max_samples=%d; their farthest "
                       "samples were dropped. Raise max_samples or use the cuda backend.",
                       count, max_samples)
    return out
