"""The plain reference of the Mixture-of-Volumetric-Primitives march, in
PyTorch and differentiable by autograd.

Semantics (the measured program's march, written down once more):

1. Culling, on the values only: the image is cut into ``tile`` x ``tile``
   ray tiles; each tile's ray cone is tested against every primitive's
   bounding sphere (radius |1 / primscale|), or, from 65,536 primitives up,
   first against the bounding spheres of Morton-ordered groups of
   ``cull_group_size`` primitives of which the earliest ``cull_max_groups``
   are kept. The ``max_hit`` primitives a tile can reach earliest are its
   candidates, in that order (ties by lower index).
2. Per ray, step rows ``t = tmin + r * dt`` for r in [0, nbuf) (the march
   is truncated at ``nbuf`` rows). A sample of candidate k at row r counts
   where the ray is inside k's box: local y = (p - c_k) R_k diag(s_k), all
   |y| <= 1, t in the ray's slab interval of the box and in [tmin, tmax).
   It reads the RGBA template trilinearly (align_corners, corners outside
   the box read zero) and weighs alpha by exp(-8 sum |y|^8) * dt.
3. A row's samples are summed over the candidates (rgb * a, a), and the
   rows are composited front to back with saturation: with cum the summed
   alpha before the row, the row adds (min(cum + a, 1) - min(cum, 1)) / a
   of its sums. Alpha is min(cum, 1) at the end.

Every (tile, candidate, ray) with a non-empty interval contributes its rows
[floor((tin - tmin) / dt) - 1, ceil((tout - tmin) / dt) + 1); the samples
are laid out flat and evaluated in blocks of tiles, each block under an
activation checkpoint so that its samples are recomputed in the backward
and never all held at once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

FADESCALE, FADEEXP = 8.0, 8
SAMPLES_PER_BLOCK = 6_000_000


def default_nbuf(dt: float) -> int:
    """Step rows covering the [-1, 1]^3 cube's diagonal."""
    n = int(2.0 * 3.0 ** 0.5 / float(dt)) + 4
    return -(-n // 8) * 8


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _hypot(x, y):
    x, y = torch.abs(x), torch.abs(y)
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    q = lo / torch.where(hi == 0, torch.ones_like(hi), hi)
    return torch.where(hi == 0, hi, hi * torch.sqrt(1 + q * q))


def _smallest(key, k):
    vals, idx = torch.sort(key, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def _tiles(x, tile):
    """[N, Hp, Wp, C] -> [N * nty * ntx, C, tile * tile], rays row-major."""
    n, hp, wp, ch = x.shape
    x = x.reshape(n, hp // tile, tile, wp // tile, tile, ch).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(-1, ch, tile * tile)


def _cone(centers, rads, live, apex, axis, tanmax, dmax, tile_tmin, tile_tmax, dt):
    v = centers - apex[:, None, :]
    t_c = torch.sum(v * axis[:, None, :], dim=-1)
    dist = _norm(v - t_c[..., None] * axis[:, None, :])
    hit = ((dist <= rads + torch.clamp(t_c, min=0.0) * tanmax[:, None] + dt)
           & (t_c + rads >= tile_tmin[:, None]) & (t_c - rads <= tile_tmax[:, None])
           & (tile_tmax > tile_tmin)[:, None] & live)
    return hit, t_c - rads - _hypot(t_c, dist) * dmax[:, None]


def _spread(x):
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


@torch.no_grad()
def cull(t_o, t_d, t_mm, primpos, primscale, tile_b, max_hit, dt, group, max_groups):
    """Candidates of every tile: gid [NT, MH] into the flat N * K table and
    valid [NT, MH]."""
    n, K = primpos.shape[:2]
    radii = _norm(1.0 / primscale)
    apex = t_o[:, :, 0]
    dsum = torch.sum(t_d, dim=2)
    axis = dsum / _norm(dsum)[:, None]
    cosmin = torch.clamp(torch.amin(torch.sum(t_d * axis[:, :, None], dim=1), dim=1), min=1e-3)
    tanmax = torch.sqrt(torch.clamp(1.0 - cosmin ** 2, 0.0, 1.0)) / cosmin
    dmax = torch.sqrt(torch.clamp(2.0 * (1.0 - cosmin), 0.0, 4.0))
    live = t_mm[:, 0] < t_mm[:, 1]
    big = 1e9
    tile_tmin = torch.amin(torch.where(live, t_mm[:, 0], big), dim=1)
    tile_tmax = torch.amax(torch.where(live, t_mm[:, 1], -big), dim=1)
    cone = (apex, axis, tanmax, dmax, tile_tmin, tile_tmax, dt)
    ntiles = t_o.shape[0]
    alive = torch.ones((n, K), dtype=torch.bool, device=primpos.device)
    if K < 65536:
        hit, tstart = _cone(primpos[tile_b], radii[tile_b], alive[tile_b], *cone)
        key, order = _smallest(torch.where(hit, tstart, math.inf), min(max_hit, K))
        gids = tile_b[:, None] * K + order
    else:
        g = max(1, min(group, K))
        G = -(-K // g)
        lo = torch.amin(primpos, dim=1, keepdim=True)
        span = torch.clamp(torch.amax(primpos, dim=1, keepdim=True) - lo, min=1e-6)
        q = torch.clamp((primpos - lo) / span * 1023.0, 0.0, 1023.0).to(torch.int64)
        code = (_spread(q[..., 0]) << 2) | (_spread(q[..., 1]) << 1) | _spread(q[..., 2])
        order_s = torch.argsort(code, dim=1, stable=True)
        pos_s = torch.gather(primpos, 1, order_s[..., None].expand(-1, -1, 3))
        rad_s = torch.gather(radii, 1, order_s)
        live_s = torch.ones_like(rad_s, dtype=torch.bool)
        if G * g > K:
            pad = G * g - K
            pos_s, rad_s = F.pad(pos_s, (0, 0, 0, pad)), F.pad(rad_s, (0, pad))
            live_s, order_s = F.pad(live_s, (0, pad)), F.pad(order_s, (0, pad))
        mem, mem_rad, mem_live = pos_s.reshape(n, G, g, 3), rad_s.reshape(n, G, g), \
            live_s.reshape(n, G, g)
        glo = torch.amin(torch.where(mem_live[..., None], mem, big), dim=2)
        ghi = torch.amax(torch.where(mem_live[..., None], mem, -big), dim=2)
        cg = 0.5 * (glo + ghi)
        rg = torch.amax(torch.where(mem_live, _norm(mem - cg[:, :, None]) + mem_rad,
                                    torch.zeros_like(mem_rad)), dim=2)
        ghit, gstart = _cone(cg[tile_b], rg[tile_b], torch.any(mem_live, 2)[tile_b], *cone)
        M = min(max_groups, G)
        gkey, gorder = _smallest(torch.where(ghit, gstart, math.inf), M)
        sel = tile_b[:, None] * G + gorder
        centers = mem.reshape(n * G, g, 3)[sel].reshape(ntiles, M * g, 3)
        rads = mem_rad.reshape(n * G, g)[sel].reshape(ntiles, M * g)
        live_c = mem_live.reshape(n * G, g)[sel].reshape(ntiles, M * g) & torch.repeat_interleave(
            torch.isfinite(gkey), g, dim=1)
        local = order_s.reshape(n * G, g)[sel].reshape(ntiles, M * g)
        hit, tstart = _cone(centers, rads, live_c, *cone)
        key, order = _smallest(torch.where(hit, tstart, math.inf), min(max_hit, M * g))
        gids = tile_b[:, None] * K + torch.gather(local, 1, order)
    valid = torch.isfinite(key)
    return torch.where(valid, gids, torch.zeros_like(gids)), valid


def _slab(A, b, o, d, tmin, tmax):
    """Local origins and directions [.., 3] and the slab interval of the
    box for rays o, d under the affine (A, b)."""
    oy = torch.einsum("...i,...ij->...j", o, A) + b
    dy = torch.einsum("...i,...ij->...j", d, A)
    dy_safe = torch.where(torch.abs(dy) < 1e-9, torch.where(dy >= 0, 1e-9, -1e-9), dy)
    t1, t2 = (-1.0 - oy) / dy_safe, (1.0 - oy) / dy_safe
    tin = torch.maximum(torch.amax(torch.minimum(t1, t2), dim=-1), tmin)
    tout = torch.minimum(torch.amin(torch.maximum(t1, t2), dim=-1), tmax)
    return oy, dy, tin, tout


def _trilinear(boxes, box, f, bs):
    """boxes [B, bs^3, C], box [S] rows of it, f [S, 3] cell coordinates ->
    [S, C]; corners outside the box read zero."""
    flat = boxes.reshape(-1, boxes.shape[-1])
    f0 = torch.floor(f)
    w1 = f - f0
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                c = f0 + f0.new_tensor([dx, dy, dz])
                ok = torch.all((c >= 0) & (c <= bs - 1), dim=-1)
                ci = torch.clamp(c, 0, bs - 1).long()
                idx = box * bs ** 3 + (ci[:, 2] * bs + ci[:, 1]) * bs + ci[:, 0]
                wgt = ((w1[:, 0] if dx else 1 - w1[:, 0]) * (w1[:, 1] if dy else 1 - w1[:, 1])
                       * (w1[:, 2] if dz else 1 - w1[:, 2]))
                out = out + torch.where(ok[:, None], flat[idx], 0.0) * wgt[:, None]
    return out


def _block(A, b, boxes, o, d, tmin, tmax, trip, row, dt, nbuf, bs):
    """Composited RGBA [T, T2, 4] of a block of T tiles: A [T, MH, 3, 3],
    b [T, MH, 3], boxes [T * MH, bs^3, 4], o / d [T, T2, 3], tmin / tmax
    [T, T2]; trip [S, 3] the (tile, candidate, ray) of each sample and row
    [S] its step row."""
    T, T2 = tmin.shape
    ti, ci, ri = trip[:, 0], trip[:, 1], trip[:, 2]
    t = tmin[ti, ri] + row.to(tmin.dtype) * dt
    oy, dy, tin, tout = _slab(A[ti, ci], b[ti, ci], o[ti, ri], d[ti, ri], tmin[ti, ri],
                              tmax[ti, ri])
    y = oy + t[:, None] * dy
    mask = (torch.all((y >= -1.0) & (y <= 1.0), dim=-1) & (tin < tout) & (t >= tin)
            & (t < tout) & (t >= tmin[ti, ri]) & (t < tmax[ti, ri]))
    fade = torch.exp(-FADESCALE * torch.sum(torch.abs(y) ** FADEEXP, dim=-1))
    smp = _trilinear(boxes, ti * A.shape[1] + ci, (y + 1.0) * (0.5 * (bs - 1)), bs)
    a = torch.where(mask, smp[:, 3] * fade * dt, 0.0)
    contrib = torch.cat([torch.where(mask[:, None], smp[:, :3], 0.0) * a[:, None], a[:, None]],
                        dim=-1)
    acc = torch.zeros((T * T2 * nbuf, 4), dtype=contrib.dtype, device=contrib.device)
    acc = acc.index_add(0, (ti * T2 + ri) * nbuf + row, contrib).reshape(T, T2, nbuf, 4)
    a_row = acc[..., 3]
    cum = torch.cumsum(a_row, dim=-1)
    scale = (torch.clamp(cum, max=1.0) - torch.clamp(cum - a_row, max=1.0)) / torch.clamp(
        a_row, min=1e-12)
    rgb = torch.sum(acc[..., :3] * scale[..., None], dim=2)
    return torch.cat([rgb, torch.clamp(cum[..., -1:], max=1.0)], dim=-1)


def mvp_march(raypos, raydir, tminmax, primpos, primrot, primscale, template, dt, tile=16,
              max_hit=64, nbuf=None, cull_group_size=256, cull_max_groups=8):
    """raypos / raydir [N, H, W, 3], tminmax [N, H, W, 2], primpos /
    primscale [N, K, 3], primrot [N, K, 3, 3], template [N, K, bs, bs, bs,
    4] -> RGBA [N, H, W, 4], differentiable in primpos, primrot, primscale
    and template."""
    nbuf = default_nbuf(dt) if nbuf is None else int(nbuf)
    n, h, w = raypos.shape[:3]
    K, bs = primpos.shape[1], template.shape[2]
    tminmax = torch.stack([tminmax[..., 0], torch.minimum(tminmax[..., 1],
                                                          tminmax[..., 0] + nbuf * dt)], -1)
    hp, wp = -(-h // tile) * tile, -(-w // tile) * tile
    pad = (0, 0, 0, wp - w, 0, hp - h)
    t_o = _tiles(F.pad(raypos, pad), tile)
    t_d = _tiles(F.pad(raydir, pad, value=1.0), tile)
    t_mm = _tiles(F.pad(tminmax, pad, value=0.0), tile)
    nty, ntx = hp // tile, wp // tile
    ntiles = n * nty * ntx
    tile_b = torch.arange(ntiles, device=raypos.device) // (nty * ntx)
    gid, valid = cull(t_o, t_d, t_mm, primpos.detach(), primscale.detach(), tile_b, max_hit,
                      dt, cull_group_size, cull_max_groups)
    mh = gid.shape[1]
    A = primrot.reshape(-1, 3, 3)[gid] * primscale.reshape(-1, 3)[gid][..., None, :]
    b = -torch.sum(primpos.reshape(-1, 3)[gid][..., :, None] * A, dim=-2)
    vf = valid.to(A.dtype)[..., None]
    A = A * vf[..., None]
    b = b * vf + (1.0 - vf) * 4.0  # an empty slab interval
    boxes = template.reshape(n * K, bs ** 3, 4)[gid.reshape(-1)]  # [NT * MH, bs^3, 4]
    o, d = t_o.transpose(1, 2).contiguous(), t_d.transpose(1, 2).contiguous()
    tmin, tmax = t_mm[:, 0].contiguous(), t_mm[:, 1].contiguous()

    with torch.no_grad():  # each (tile, candidate, ray)'s rows, and the blocks of tiles
        _, _, tin, tout = _slab(A[:, :, None], b[:, :, None], o[:, None], d[:, None],
                                tmin[:, None], tmax[:, None])
        lo = torch.clamp(torch.floor((tin - tmin[:, None]) / dt) - 1.0, 0.0, float(nbuf))
        hi = torch.clamp(torch.ceil((tout - tmin[:, None]) / dt) + 1.0, 0.0, float(nbuf))
        nrows = torch.where(tin < tout, hi - lo, 0.0).long()  # [NT, MH, T2]
        per_tile = nrows.sum(dim=(1, 2)).tolist()
    out, start = [], 0
    while start < ntiles:
        end, count = start + 1, per_tile[start]
        while end < ntiles and end - start < 256 and count + per_tile[end] <= SAMPLES_PER_BLOCK:
            count += per_tile[end]
            end += 1
        with torch.no_grad():
            nr = nrows[start:end].reshape(-1)
            keep = torch.nonzero(nr).flatten()
            reps = nr[keep]
            total = int(reps.sum())
            trip = torch.stack(torch.unravel_index(keep, nrows[start:end].shape), dim=-1)
            trip = torch.repeat_interleave(trip, reps, dim=0, output_size=total)
            first = torch.cumsum(reps, 0) - reps
            lo_b = lo[start:end].reshape(-1)[keep].long()
            row = (torch.arange(total, device=nr.device)
                   - torch.repeat_interleave(first, reps, output_size=total)
                   + torch.repeat_interleave(lo_b, reps, output_size=total))
        sl = slice(start, end)
        out.append(torch.utils.checkpoint.checkpoint(
            _block, A[sl], b[sl], boxes[start * mh:end * mh], o[sl], d[sl], tmin[sl], tmax[sl],
            trip, row, dt, nbuf, bs, use_reentrant=False))
        start = end
    rgba = torch.cat(out, dim=0)  # [NT, T2, 4]
    rgba = rgba.reshape(n, nty, ntx, tile, tile, 4).permute(0, 1, 3, 2, 4, 5)
    return rgba.reshape(n, hp, wp, 4)[:, :h, :w]
