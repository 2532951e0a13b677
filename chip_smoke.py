# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel of the port, one nvcc per source, all started
   together;
3. kernel vs plain on small scenes (bs 2/4/8/16, warp, prim_mask, opaque);
4. the render path at the full width of the flagship model
   (configs/config-synthetic-flagship.yaml: batch 4, 512x334 rays, 1024^2
   textures, 16384 primitives of 8^3, tile 16, max_hit 64, nbuf auto = 896,
   colorcal and background on), weights from a seeded generator: one warm-up
   forward with running_avg_scale=True, then 3 batches rendered self-id and
   cross-id as render.py does, under torch.inference_mode();
5. kernel vs plain on that flagship scene, with the kernel's time, the plain
   version's time and the kernel's bound.

Tolerance kernel vs plain: rtol = atol = 1e-5. Both run the same fp32
operations in the same order (the kernel is built without FMA contraction);
what is left is ulp-level rounding of expf and division.

The second-to-last lines are the kernel table (JSON) and the card's name and
power limit; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ava256_tpu_torch.data.synthetic import (
    SyntheticDataset, none_collate, raymarch_scene, synthetic_uvdata)
from ava256_tpu_torch.factory import get_autoencoder
from ava256_tpu_torch.ops import raymarch_cuda as rc
from ava256_tpu_torch.ops.cuda_lib import build_all
from ava256_tpu_torch.ops.math3d import rodrigues
from ava256_tpu_torch.render import BATCH_MODEL_KEYS, decode

RTOL = ATOL = 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
# fp32 operations the kernel spends on one sample, counted from
# csrc/mvp_march_fwd.cu: row time, local point, box and range tests, fade
# (|y|^8 by squaring, exp), cell coordinates, 8-corner trilinear of 4
# channels, step-row accumulation. A warp adds a 3-channel trilinear.
OPS_PER_SAMPLE = 175
OPS_PER_WARP_SAMPLE = 85

# configs/config-synthetic-flagship.yaml (no yaml on the card's host)
FLAGSHIP = dict(nident=4, ncams=10, nframes=32, height=512, width=334, texsize=1024,
                nprims=16384, primsize=8, batch=4, tile=16, max_hit=64)


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_close(what: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.double().cpu(), ref.double().cpu()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (got - ref).abs()
    bad = err > ATOL + RTOL * ref.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} values beyond rtol/atol {RTOL} "
                             f"(max |d| {float(err.max()):.3g})")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 3: small scenes
# ---------------------------------------------------------------------------


def small_scenes(dev: torch.device) -> float:
    worst = 0.0
    cases = [(2, False, 8, False), (4, True, 16, False), (8, True, 8, False),
             (8, False, 16, True), (16, False, 8, False)]
    for bs, warp, tile, opaque in cases:
        s = raymarch_scene(n=2, h=37, w=35, k3=3, bs=bs, warp=warp, seed=bs)
        if opaque:
            s["template"][..., 3] *= 30.0
        mask = (np.random.RandomState(0).rand(2, 27) > 0.3).astype(np.float32)
        kw = dict(fadescale=8.0, fadeexp=8.0, tile=tile, max_hit=27, nbuf=64)
        outs = []
        for d in ("cpu", dev):
            t = {k: torch.from_numpy(np.array(v)).to(d) for k, v in s.items()
                 if isinstance(v, np.ndarray)}
            outs.append(rc.mvp_raymarch_cuda(
                t["raypos"], t["raydir"], s["stepsize"], t["tminmax"], t["primpos"],
                rodrigues(t["primrvec"]), t["primscale"], t["template"], t.get("warp"),
                prim_mask=torch.from_numpy(mask).to(d), device=d, **kw))
        torch.cuda.synchronize()
        if float(outs[0][..., 3].mean()) < 0.1:
            raise AssertionError(f"bs={bs}: the small scene is nearly empty")
        worst = max(worst, check_close(f"small scene bs={bs} warp={warp}", outs[1], outs[0]))
    return worst


# ---------------------------------------------------------------------------
# phase 4: the flagship render path
# ---------------------------------------------------------------------------


def to_device(batch, dev):
    return {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in batch.items()
            if k in BATCH_MODEL_KEYS or k in ("idindex", "camindex")}


def flagship_render(dev: torch.device):
    f = FLAGSHIP
    t0 = time.perf_counter()
    ds = SyntheticDataset(nident=f["nident"], ncams=f["ncams"], nframes=f["nframes"],
                          height=f["height"], width=f["width"], texsize=f["texsize"])
    model = get_autoencoder(
        synthetic_uvdata(f["texsize"]), ds.vertmean, ds.vertstd, ncams=f["ncams"],
        nident=f["nident"], nprims=f["nprims"], primsize=(f["primsize"],) * 3,
        raymarch_options={"tile": f["tile"], "max_hit": f["max_hit"]}, device=dev, seed=0)
    model.eval()
    bsz = f["batch"]
    batches = [to_device(none_collate([ds[b * f["nident"] + i] for i in range(bsz)]), dev)
               for b in range(4)]
    cross = [ds.get_neutral_conditioning((i + 1) % f["nident"]) for i in range(bsz)]
    cross_tex = torch.from_numpy(np.stack([c["neut_avgtex"] for c in cross])).to(dev)
    cross_verts = torch.from_numpy(np.stack([c["neut_verts"] for c in cross])).to(dev)
    torch.cuda.synchronize()
    log("setup", seconds=round(time.perf_counter() - t0, 3),
        params=sum(p.numel() for p in model.parameters()))

    gen = torch.Generator(device=dev).manual_seed(1)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    per_forward, launches = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    rc.march_tiles_kernel.launches = 0  # the main path starts here
    with torch.inference_mode():
        b = batches[0]
        ev[0].record()
        warm = model(target_neut_avgtex=b["neut_avgtex"], target_neut_verts=b["neut_verts"],
                     idindex=b["idindex"], camindex=b["camindex"], running_avg_scale=True,
                     generator=gen, **{k: b[k] for k in BATCH_MODEL_KEYS})
        ev[1].record()
        torch.cuda.synchronize()
        warm_ms = ev[0].elapsed_time(ev[1])
        launches.append(rc.march_tiles_kernel.launches)
        frames = []
        for b in batches[1:]:
            for tex, verts in ((b["neut_avgtex"], b["neut_verts"]), (cross_tex, cross_verts)):
                ev[0].record()
                frames.append(decode(model, b, tex, verts))
                ev[1].record()
                torch.cuda.synchronize()
                per_forward.append(ev[0].elapsed_time(ev[1]))
                launches.append(rc.march_tiles_kernel.launches)
    main_launches = rc.march_tiles_kernel.launches  # the main path ends here
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    if any(b <= a for a, b in zip([0] + launches, launches)):
        raise AssertionError(f"a forward did not launch the kernel: counts {launches}")
    aw = model.decoder_assembler.adaptwarps
    if not bool(torch.isfinite(aw).all()) or float(aw.min()) <= 0:
        raise AssertionError("adaptwarps not set by the running_avg_scale forward")
    shape = (bsz, f["height"], f["width"], 3)
    for i, fr in enumerate([warm["irgbrec"]] + frames):
        if tuple(fr.shape) != shape or not bool(torch.isfinite(fr).all()):
            raise AssertionError(f"render {i}: shape {tuple(fr.shape)} or non-finite values")
    self_cross = float((frames[0] - frames[1]).abs().mean())
    if self_cross == 0.0:
        raise AssertionError("self-id and cross-id renders are identical")

    # the scene of a render: decoder output and rays, for the alpha coverage
    # and phase 5
    b = batches[1]
    with torch.inference_mode():
        out = model(target_neut_avgtex=b["neut_avgtex"], target_neut_verts=b["neut_verts"],
                    idindex=b["idindex"], camindex=b["camindex"], deterministic=True,
                    output_set=frozenset({"march_inputs", "ialpha"}),
                    **{k: b[k] for k in BATCH_MODEL_KEYS})
    coverage = float((out["ialpha"] > 0.01).float().mean())
    if not 0.01 < coverage:
        raise AssertionError(f"alpha coverage {coverage}: the scene is empty")
    log("render", forwards=len(launches), launches=main_launches,
        warmup_ms=round(warm_ms, 3), ms_per_forward=round(float(np.mean(per_forward)), 3),
        ms_each=[round(x, 3) for x in per_forward], peak_gib=round(peak_gib, 3),
        alpha_coverage=round(coverage, 4), self_vs_cross_mean_abs=round(self_cross, 3))
    return out["march_inputs"], main_launches, float(np.mean(per_forward))


# ---------------------------------------------------------------------------
# phase 5: kernel vs plain on the flagship scene
# ---------------------------------------------------------------------------


def flagship_kernel(mi, dev: torch.device):
    f = FLAGSHIP
    dt = float(mi["stepsize"])
    nbuf = rc.default_nbuf(dt)
    n, K = mi["primpos"].shape[:2]
    bs = mi["template"].shape[2]
    with torch.inference_mode():
        march_ms = cuda_ms(lambda: rc.mvp_raymarch_cuda(
            mi["raypos"], mi["raydir"], dt, mi["tminmax"], mi["primpos"], mi["primrot"],
            mi["primscale"], mi["template"], tile=f["tile"], max_hit=f["max_hit"],
            device=dev), reps=3)
        tmm = mi["tminmax"]
        tmm = torch.stack([tmm[..., 0], torch.minimum(tmm[..., 1], tmm[..., 0] + nbuf * dt)], -1)
        pm = torch.ones((n, K), device=dev)
        t_o, t_d, t_mm, gid, valid, _, _ = rc.tile_and_cull(
            mi["raypos"], mi["raydir"], tmm, mi["primpos"], mi["primscale"], pm, f["tile"],
            f["max_hit"], dt)
        scal = rc.candidate_affines(mi["primpos"], mi["primrot"], mi["primscale"], gid, valid)
        args = (gid.to(torch.int32).contiguous(), scal, t_o, t_d, t_mm,
                mi["template"].reshape(n * K, bs, bs, bs, 4).contiguous(), None, dt, 8.0, 8.0,
                nbuf)
        kern = rc.march_tiles_kernel(*args)
        kernel_ms = cuda_ms(lambda: rc.march_tiles_kernel(*args), reps=5)
        counts = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = rc.march_tiles_plain(*args, counts=counts)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    err = check_close("flagship scene", kern, plain)

    ntiles, mh = gid.shape
    t2 = t_o.shape[2]
    boxes = int(torch.unique(gid[valid]).numel())
    samples = int(counts["samples"])
    nbytes = (boxes * bs**3 * 4 * 4 + ntiles * mh * (4 + 12 * 4) + ntiles * t2 * 8 * 4
              + ntiles * 4 * t2 * 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = samples * OPS_PER_SAMPLE / FP32_OPS_PER_S * 1e3
    no_reuse_ms = ntiles * mh * bs**3 * 16 / HBM_BYTES_PER_S * 1e3
    log("flagship-kernel", tiles=ntiles, max_hit=mh, nbuf=nbuf, valid_candidates=int(valid.sum()),
        boxes=boxes, samples=samples, bytes=nbytes, max_abs_err=err,
        kernel_ms=round(kernel_ms, 4), plain_ms=round(plain_ms, 3),
        raymarch_op_ms=round(march_ms, 4), bound_bytes_ms=round(bytes_ms, 5),
        bound_ops_ms=round(ops_ms, 5), per_tile_box_bytes_ms=round(no_reuse_ms, 5))
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, smi=repr(smi))

    t0 = time.perf_counter()
    build_all([rc.MARCH_FWD_LIB])
    ptxas = [ln.strip() for ln in rc.MARCH_FWD_LIB.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", seconds=round(time.perf_counter() - t0, 3), ptxas=ptxas)

    small_err = small_scenes(dev)
    log("small-scenes", max_abs_err=small_err)

    mi, launches, fwd_ms = flagship_render(dev)
    k = flagship_kernel(mi, dev)

    table = {"kernels": [dict(
        name="mvp_march_fwd", route="cuda", source="ava256_tpu_torch/csrc/mvp_march_fwd.cu",
        replaces="ava256_tpu/ops/raymarch_pallas.py:831", launches=launches,
        max_abs_err=max(small_err, k["max_abs_err"]), ms=k["ms"], plain_ms=k["plain_ms"],
        bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=None)]}
    log("done", seconds=round(time.perf_counter() - t_start, 3), ms_per_forward=fwd_ms)
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
