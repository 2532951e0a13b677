# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Raymarch micro-benchmark and on-device check, the port of
``scripts/kbench.py``.

    python -m ava256_tpu_torch.kbench [--verify] [--backend cuda|xla]
        [--scene NPZ] [--batch 4] [--hw 512x334] [--nprims 16384] [--steps 3]
        [--device cuda]

Times the march's forward and its gradient (CUDA events, mean of
``--steps`` calls after a warm-up) on the flagship shell scene or on march
operands dumped by ``python -m ava256_tpu_torch.bench``
(``AVA256_BENCH_SAVE_MARCH``), and prints one JSON line: the times, Mrays/s,
the cull alone, the valid candidates, the mean alpha and the forward's
multiple of its HBM speed of light. ``--backend cuda`` times the
hand-written kernels (``mvp_raymarch_cuda``), ``--backend xla`` the
compacted marcher in plain PyTorch (``raymarch_xla``; then also the rays that
overflowed ``--max-samples``).

The speed of light is the least time to stream every valid (tile,
candidate) RGBA box and the tiles' rays and output once from HBM, at the
card's own rate: 3,350 GB/s for the H100 80GB HBM3 (NVIDIA's data sheet),
or ``AVA256_HBM_GBPS``. The line names the device beside it. On a device
that is not a CUDA card the rate is only what ``AVA256_HBM_GBPS`` says.

``--verify`` holds the CUDA kernels against the port's oracle
(``raymarch_ref``, the kernels' summed-within-step rule) on a reduced scene
(1 x 16 x 16 rays, 16 primitives): the output's and each gradient's cosine,
and exits 1 below the oracle tests' thresholds (0.9999 output, 0.999
gradients).

``--rows``, ``--bwd-stop``, ``--fwd-stop`` and ``--candidates`` shape or
truncate the TPU kernels and have no counterpart in the port's kernels:
anything but their defaults raises.

Scene: primitives jittered on a spherical shell (the shape the decoder's
assembler converges to for a head), scales from the spacing between them,
camera at 3 volume radii; made by numpy from a seed, as the JAX script's.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ava256_tpu_torch.ops import raymarch_cuda as rc
from ava256_tpu_torch.ops.math3d import rodrigues
from ava256_tpu_torch.ops.raymarch_cuda import mvp_raymarch_cuda, resolve_device
from ava256_tpu_torch.ops.raymarch_ref import mvp_raymarch_reference
from ava256_tpu_torch.ops.raymarch_xla import cull_tiles, march_compacted

H100_HBM_GBPS = 3350.0  # NVIDIA H100 80GB HBM3 (SXM): 3.35 TB/s
# flags of the JAX script that shape the TPU kernels, with their defaults
TPU_ONLY_FLAGS = {"rows": 4, "bwd_stop": 4, "fwd_stop": 2, "candidates": "dma"}
SCENE_KEYS = ("raypos", "raydir", "tminmax", "primpos", "primrot", "primscale", "template")


def make_flagship_scene(batch=4, h=512, w=334, nprims=16384, boxsize=8, seed=0):
    """The JAX script's seeded shell scene, as numpy arrays (plus the
    rotation vectors, ``primrvec``, that ``primrot`` is made from)."""
    rng = np.random.RandomState(seed)
    n, K, M = batch, nprims, boxsize

    # primitives on a jittered spherical shell, radius 0.7 in volume units
    u = rng.rand(K).astype(np.float32)
    phi = rng.rand(K).astype(np.float32) * 2 * np.pi
    cz = 2 * u - 1
    s = np.sqrt(np.maximum(0.0, 1 - cz * cz))
    pts = np.stack([s * np.cos(phi), s * np.sin(phi), cz], -1) * 0.7
    spacing = np.sqrt(4 * np.pi * 0.49 / K)  # mean inter-prim distance
    primpos = (pts + rng.randn(K, 3).astype(np.float32) * spacing * 0.3)[None]
    primpos = np.tile(primpos, (n, 1, 1)).astype(np.float32)
    # world halfwidth ~= 1.5x spacing (overlapping shell like the EMA scale)
    primscale = np.full((n, K, 3), 1.0 / (1.5 * spacing), np.float32)
    ang = rng.randn(n, K, 3).astype(np.float32) * 0.1
    primrot = rodrigues(torch.from_numpy(ang)).numpy()
    template = rng.randn(n, K, M, M, M, 4).astype(np.float32)
    template[..., 3] -= 2.0
    template = np.log1p(np.exp(template)) * np.array([60, 60, 60, 8], np.float32)

    # camera at 3 volume radii, rays through the unit cube
    campos = np.array([0.0, 0.0, -3.0], np.float32)
    focal = w * 1.2
    px, py = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    rd = np.stack([(px - w / 2) / focal, (py - h / 2) / focal, np.ones_like(px)], -1)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    raydir = np.tile(rd[None], (n, 1, 1, 1)).astype(np.float32)
    raypos = np.tile(campos[None, None, None], (n, h, w, 1)).astype(np.float32)
    # slab test against [-1,1]^3
    inv = 1.0 / np.where(np.abs(raydir) < 1e-9, 1e-9, raydir)
    t1 = (-1.0 - raypos) * inv
    t2 = (1.0 - raypos) * inv
    tmin = np.maximum(np.minimum(t1, t2).max(-1), 0.0)
    tmax = np.maximum(t1, t2).min(-1)
    tminmax = np.stack([tmin, np.maximum(tmax, tmin)], -1).astype(np.float32)
    stepsize = 1.0 / 256.0
    return dict(
        raypos=raypos, raydir=raydir, stepsize=stepsize, tminmax=tminmax,
        primpos=primpos, primrot=primrot, primscale=primscale, template=template,
        primrvec=ang,
    )


def hbm_rate(device: torch.device, hbm_gbps: Optional[float] = None) -> Optional[float]:
    """GB/s of the device's memory: the argument, else ``AVA256_HBM_GBPS``,
    else the H100's on a CUDA card; None on another device."""
    if hbm_gbps is None and os.environ.get("AVA256_HBM_GBPS"):
        hbm_gbps = float(os.environ["AVA256_HBM_GBPS"])
    if hbm_gbps is None and device.type == "cuda":
        hbm_gbps = H100_HBM_GBPS
    return hbm_gbps


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_calls(fn, reps: int, device: torch.device) -> float:
    """Mean seconds of fn() over reps calls after one warm-up call: CUDA
    events on the card, the host clock around synchronized work elsewhere."""
    fn()
    sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def measure_raymarch_arrays(rp, rd, stepsize, tmm, pp, pr, ps, tpl, warp=None,
                            prim_mask=None, steps=3, tile=16, max_hit=64, hbm_gbps=None,
                            two_stage=None, cull_max_groups=8, cull_group_size=256,
                            fadescale=8.0, fadeexp=8.0, backend="cuda", max_samples=128,
                            chunk_tiles=64):
    """Time the march forward and its gradient (in primpos, primrot,
    primscale and template) on the given operands, all on one device, and
    derive the forward's multiple of its HBM speed of light. Returns (the
    report, (fwd, grad)): fwd(pp, pr, ps, tpl) -> RGBA, grad(...) -> the four
    gradients of the output's sum."""
    device = rp.device
    stepsize = float(stepsize)
    if backend == "cuda":
        kw = dict(fadescale=fadescale, fadeexp=fadeexp, tile=tile, max_hit=max_hit,
                  two_stage_cull=two_stage, cull_max_groups=cull_max_groups,
                  cull_group_size=cull_group_size, prim_mask=prim_mask, device=device)

        def fwd(pp, pr, ps, tpl):
            return mvp_raymarch_cuda(rp, rd, stepsize, tmm, pp, pr, ps, tpl, warp, **kw)
    elif backend == "xla":
        if prim_mask is not None:
            raise ValueError("the compacted marcher takes no prim_mask")
        overflow = []

        def fwd(pp, pr, ps, tpl):
            out, n_over = march_compacted(
                rp, rd, stepsize, tmm, pp, pr, ps, tpl, warp, fadescale=fadescale,
                fadeexp=fadeexp, tile=tile, max_hit=max_hit, max_samples=max_samples,
                chunk_tiles=chunk_tiles)
            overflow.append(n_over)
            return out
    else:
        raise ValueError(f"backend must be 'cuda' or 'xla', got {backend!r}")

    def grad(pp, pr, ps, tpl):
        leaves = [x.detach().requires_grad_() for x in (pp, pr, ps, tpl)]
        return torch.autograd.grad(torch.sum(fwd(*leaves)), leaves)

    with torch.no_grad():
        out = fwd(pp, pr, ps, tpl)
        t_fwd = time_calls(lambda: fwd(pp, pr, ps, tpl), steps, device)
    t_tot = time_calls(lambda: grad(pp, pr, ps, tpl), steps, device)
    t_bwd = t_tot - t_fwd

    # the cull alone (the CUDA op's: the candidates the kernels march), on
    # the rays' range as the op cuts it at nbuf step rows
    nbuf = rc.default_nbuf(stepsize)
    tmm_c = torch.stack([tmm[..., 0], torch.minimum(tmm[..., 1], tmm[..., 0] + nbuf * stepsize)],
                        dim=-1)
    pm = (torch.ones(pp.shape[:2], dtype=torch.float32, device=device) if prim_mask is None
          else prim_mask.to(torch.float32))

    def cull():
        return rc.tile_and_cull(rp, rd, tmm_c, pp, ps, pm, tile, max_hit, stepsize,
                                cull_group_size=cull_group_size,
                                cull_max_groups=cull_max_groups, two_stage=two_stage)

    with torch.no_grad():
        t_o, _, _, _, cand_valid, _, _ = cull()
        t_cull = time_calls(cull, steps, device)
    nval = int(cand_valid.sum())
    bs = tpl.shape[2]
    box_bytes = nval * bs * bs * bs * 4 * 4
    ray_bytes = t_o.shape[0] * t_o.shape[2] * (3 + 3 + 2 + 4) * 4
    gbps = hbm_rate(device, hbm_gbps)
    sol_s = None if gbps is None else (box_bytes + ray_bytes) / (gbps * 1e9)
    nrays = int(np.prod(rp.shape[:-1]))
    rep = {
        "fwd_s": t_fwd,
        "cull_s": t_cull,
        "bwd_s": t_bwd,
        "bwd_over_fwd": t_bwd / t_fwd,
        "grad_total_s": t_tot,
        "mrays_per_s_fwd": nrays / t_fwd / 1e6,
        "hbm_gbps": gbps,
        "hbm_sol_s": sol_s,
        "x_hbm_speed_of_light": None if sol_s is None else t_fwd / sol_s,
        "candidates": nval,
        "alpha_mean": float(torch.mean(out[..., 3])),
        "backend": backend,
        "device": device_name(device),
    }
    if backend == "xla":
        rep["max_samples"] = max_samples
        rep["overflow_rays"] = int(overflow[0])
    return rep, (fwd, grad)


def scene_tensors(s, device):
    return {k: torch.from_numpy(np.ascontiguousarray(s[k])).to(device)
            for k in SCENE_KEYS + ("warp",) if s.get(k) is not None}


def measure_raymarch(batch=4, h=512, w=334, nprims=16384, steps=3, tile=16, max_hit=64, seed=0,
                     hbm_gbps=None, boxsize=8, two_stage=None, cull_max_groups=8,
                     cull_group_size=256, mask_frac=0.0, backend="cuda", max_samples=128,
                     chunk_tiles=64, device="cuda"):
    """``measure_raymarch_arrays`` on the synthetic shell scene. mask_frac >
    0 marks that fraction of the primitives dead through prim_mask (the
    alpha-mask culling path; the CUDA backend only)."""
    device = resolve_device(device)
    s = make_flagship_scene(batch, h, w, nprims, boxsize=boxsize, seed=seed)
    t = scene_tensors(s, device)
    prim_mask = None
    if mask_frac > 0.0:
        mrng = np.random.RandomState(seed + 1)
        prim_mask = torch.from_numpy(
            (mrng.rand(1, nprims) >= mask_frac).astype(np.float32).repeat(batch, 0)).to(device)
    rep, (fwd, grad) = measure_raymarch_arrays(
        t["raypos"], t["raydir"], s["stepsize"], t["tminmax"], t["primpos"], t["primrot"],
        t["primscale"], t["template"], prim_mask=prim_mask, steps=steps, tile=tile,
        max_hit=max_hit, hbm_gbps=hbm_gbps, two_stage=two_stage,
        cull_max_groups=cull_max_groups, cull_group_size=cull_group_size, backend=backend,
        max_samples=max_samples, chunk_tiles=chunk_tiles)
    return rep, (fwd, grad, s, t)


def load_scene_npz(path):
    """March operands dumped by the bench (``AVA256_BENCH_SAVE_MARCH``): the
    step's own scene, for offline work on the march."""
    data = np.load(path)
    s = {k: data[k] for k in data.files}
    s["stepsize"] = float(s["stepsize"])
    return s


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a * b).sum() / torch.sqrt((a * a).sum() * (b * b).sum() + 1e-30))


def truncated_tiles(t, stepsize, tile: int, max_hit: int) -> int:
    """Tiles of the scene ``t`` where the CUDA op's cull or the compacted
    marcher's may have dropped hits beyond max_hit (all max_hit < K
    candidates valid), the larger of the two counts."""
    if max_hit >= t["primpos"].shape[1]:
        return 0
    rp, rd, tmm, pp, ps = (t[k] for k in ("raypos", "raydir", "tminmax", "primpos", "primscale"))
    with torch.no_grad():
        pm = torch.ones(pp.shape[:2], device=rp.device)
        valid_k = rc.tile_and_cull(rp, rd, tmm, pp, ps, pm, tile, max_hit, float(stepsize))[4]
        valid_x = cull_tiles(rp, rd, tmm, pp, ps, tile, max_hit, float(stepsize))[4]
    return max(int((v.sum(1) == max_hit).sum()) for v in (valid_k, valid_x))


def compare_with_kernels(t, stepsize, tile=16, max_hit=64, max_samples=128, chunk_tiles=64,
                         fadescale=8.0, fadeexp=8.0, seed=0) -> dict:
    """The compacted marcher against the CUDA op (the kernels on the card,
    their plain versions on the CPU) on the scene ``t`` (``scene_tensors``):
    the same samples, since the op marches every row (nbuf covers the
    longest ray) and the caller picks a max_hit that neither cull fills (see
    ``truncated_tiles``) and a max_samples that no ray overflows (see
    ``overflow_rays``). The two composite a step's samples by different
    rules once a ray saturates: the kernels add the step's densities first,
    the compacted marcher takes them near to far. So the images are
    compared on the rays that saturate in neither (``free_share`` of all),
    the alpha on every ray, and the gradients of the leaves (primpos,
    primrot, primscale, template, warp) under a seeded cotangent on those
    rays. Returns the numbers; the caller holds them to its limits.

    The two also differ in how they round a sample's place in its box (the
    kernels: the tile's affine, origin plus t times direction; the marcher:
    JAX's ``((o + t d) - c) R s``), so a sample within an ulp of a box face
    can be in one march and not in the other. There the fade has its
    steepest slope (64 e^-8 per unit at fadescale = fadeexp = 8): such a
    sample moves a ray's colour by about 1e-4 and its primitive's geometric
    gradient by a few percent. ``image_worst_free`` and
    ``grad_*_prims_beyond_1e-3`` show how many values that reaches."""
    dt = float(stepsize)
    rp, rd, tmm = t["raypos"], t["raydir"], t["tminmax"]
    names = ["primpos", "primrot", "primscale", "template"] + (["warp"] if "warp" in t else [])
    longest = float((tmm[..., 1] - tmm[..., 0]).max())
    nbuf = max(rc.default_nbuf(dt), rc._ceil_to(int(np.ceil(longest / dt)) + 1, 8))
    kw = dict(fadescale=fadescale, fadeexp=fadeexp, tile=tile, max_hit=max_hit)
    truncated = truncated_tiles(t, dt, tile, max_hit)

    def run(march):
        leaves = [t[k].detach().requires_grad_() for k in names]
        return march(*leaves), leaves

    out_k, leaves_k = run(lambda pp, pr, ps, tpl, *w: mvp_raymarch_cuda(
        rp, rd, dt, tmm, pp, pr, ps, tpl, w[0] if w else None, nbuf=nbuf, device=rp.device,
        **kw))
    overflow = []
    out_x, leaves_x = run(lambda pp, pr, ps, tpl, *w: _keep_second(overflow, march_compacted(
        rp, rd, dt, tmm, pp, pr, ps, tpl, w[0] if w else None, max_samples=max_samples,
        chunk_tiles=chunk_tiles, **kw)))
    with torch.no_grad():
        free = (out_k[..., 3] < 1.0 - 1e-6) & (out_x[..., 3] < 1.0 - 1e-6)
        ref, got = out_k.double(), out_x.double()
        beyond = (got - ref).abs() > 1e-4 + 1e-4 * ref.abs()
        cot = torch.randn(out_k.shape, device=rp.device,
                          generator=torch.Generator(device=rp.device).manual_seed(seed))
        cot = cot * free[..., None]
    grads_k = torch.autograd.grad(torch.sum(out_k * cot), leaves_k)
    grads_x = torch.autograd.grad(torch.sum(out_x * cot), leaves_x)
    rep = {"nbuf": nbuf, "truncated_tiles": truncated, "overflow_rays": int(overflow[0]),
           "free_share": float(free.float().mean()),
           "alpha_max_abs_err": float((got - ref)[..., 3].abs().max()),
           "alpha_beyond_1e-4": int(beyond[..., 3].sum()),
           "image_max_abs_ref_free": float(ref[free].abs().max()) if free.any() else 0.0,
           "image_max_abs_err_free": float((got - ref)[free].abs().max()) if free.any() else 0.0,
           "image_beyond_1e-4_free": int(beyond[free].sum()),
           # the free ray whose image is furthest beyond 1e-4: (kernel rgba, marcher rgba)
           "image_worst_free": _worst(got, ref, free),
           "image_max_abs_err_saturated": float((got - ref)[~free].abs().max())
           if (~free).any() else 0.0}
    for name, a, b in zip(names, grads_x, grads_k):
        a, b = a.double(), b.double()
        d = (a - b).abs().reshape(a.shape[0] * a.shape[1], -1).amax(-1)  # per primitive
        rep[f"grad_{name}_rel_err"] = float(d.max() / b.abs().max())
        rep[f"grad_{name}_prims_beyond_1e-3"] = int((d > 1e-3 * b.abs().max()).sum())
        rep[f"grad_{name}_cos"] = _cosine(a, b)
    return rep


def _worst(got: torch.Tensor, ref: torch.Tensor, rays: torch.Tensor) -> list:
    excess = ((got - ref).abs() - 1e-4 * ref.abs()).amax(-1)
    excess = torch.where(rays, excess, -math.inf)
    i = int(torch.argmax(excess))
    return [ref.reshape(-1, 4)[i].tolist(), got.reshape(-1, 4)[i].tolist()]


def _keep_second(store: list, pair):
    store.append(pair[1])
    return pair[0]


def verify(device, seed=0, tile=16, max_hit=64) -> dict:
    """The CUDA kernels against the port's oracle (summed within a step, the
    kernels' rule) on the reduced shell scene: cosines of the output and of
    the four gradients of the output's sum, and the output's max |d|."""
    s = make_flagship_scene(1, 16, 16, 16, seed=seed)
    t = scene_tensors(s, device)
    leaves = ("primpos", "primrot", "primscale", "template")
    maxsteps = int(np.ceil(float(s["tminmax"][..., 1].max()) / s["stepsize"])) + 2

    def run(march):
        x = [t[k].detach().requires_grad_() for k in leaves]
        out = march(*x)
        return out.detach(), torch.autograd.grad(torch.sum(out), x)

    out, g = run(lambda pp, pr, ps, tpl: mvp_raymarch_cuda(
        t["raypos"], t["raydir"], s["stepsize"], t["tminmax"], pp, pr, ps, tpl, None,
        tile=tile, max_hit=max_hit, device=device))
    ref, gr = run(lambda pp, pr, ps, tpl: mvp_raymarch_reference(
        t["raypos"], t["raydir"], s["stepsize"], t["tminmax"], pp, pr, ps, tpl, None,
        max_steps=maxsteps, within_step="summed"))
    rep = {"out_dp": _cosine(out, ref), "out_maxdiff": float((out - ref).abs().max())}
    for name, a, b in zip(leaves, g, gr):
        rep[f"grad_{name}_dp"] = _cosine(a, b)
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--scene", default=None,
                    help="march-operand .npz from the bench instead of the shell scene")
    ap.add_argument("--backend", choices=["cuda", "xla"], default="cuda")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--hw", default="512x334")
    ap.add_argument("--nprims", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--tile", type=int, default=16)
    ap.add_argument("--max-hit", type=int, default=64)
    ap.add_argument("--max-samples", type=int, default=128, help="the xla backend's budget")
    ap.add_argument("--chunk-tiles", type=int, default=64, help="the xla backend's chunk")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--boxsize", type=int, default=8)
    ap.add_argument("--two-stage", choices=["auto", "on", "off"], default="auto")
    ap.add_argument("--cull-max-groups", type=int, default=8)
    ap.add_argument("--cull-group-size", type=int, default=256)
    ap.add_argument("--mask-frac", type=float, default=0.0,
                    help="fraction of primitives marked dead via prim_mask")
    # the JAX script's TPU-kernel flags: accepted at their defaults only
    ap.add_argument("--rows", type=int, default=TPU_ONLY_FLAGS["rows"])
    ap.add_argument("--bwd-stop", type=int, default=TPU_ONLY_FLAGS["bwd_stop"])
    ap.add_argument("--fwd-stop", type=int, default=TPU_ONLY_FLAGS["fwd_stop"])
    ap.add_argument("--candidates", default=TPU_ONLY_FLAGS["candidates"])
    args = ap.parse_args(argv)
    for name, default in TPU_ONLY_FLAGS.items():
        if getattr(args, name) != default:
            ap.error(f"--{name.replace('_', '-')} shapes the TPU kernels and has no "
                     f"counterpart in the port's CUDA kernels; leave it at {default!r}")
    device = resolve_device(args.device)
    h, w = map(int, args.hw.split("x"))
    two_stage = {"auto": None, "on": True, "off": False}[args.two_stage]
    common = dict(steps=args.steps, tile=args.tile, max_hit=args.max_hit, two_stage=two_stage,
                  cull_max_groups=args.cull_max_groups, cull_group_size=args.cull_group_size,
                  backend=args.backend, max_samples=args.max_samples,
                  chunk_tiles=args.chunk_tiles)

    if args.scene:
        s = load_scene_npz(args.scene)
        t = scene_tensors(s, device)
        rep, _ = measure_raymarch_arrays(
            t["raypos"], t["raydir"], s["stepsize"], t["tminmax"], t["primpos"],
            t["primrot"], t["primscale"], t["template"], warp=t.get("warp"),
            fadescale=float(s.get("fadescale", 8.0)), fadeexp=float(s.get("fadeexp", 8.0)),
            **common)
        rep["scene"] = args.scene
    else:
        rep, _ = measure_raymarch(args.batch, h, w, args.nprims, seed=args.seed,
                                  boxsize=args.boxsize, mask_frac=args.mask_frac,
                                  device=device, **common)
    print(json.dumps(rep), flush=True)

    if args.verify:
        rep = verify(device, seed=args.seed, tile=args.tile, max_hit=args.max_hit)
        print(json.dumps(rep), flush=True)
        dps = [v for k, v in rep.items() if k.endswith("_dp")]
        if rep["out_dp"] <= 0.9999 or min(dps) <= 0.999:
            print("kbench --verify: the kernels disagree with the oracle", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
