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
3. forward kernel vs plain on small scenes (bs 2/4/8/16, warp, prim_mask,
   opaque), then the backward kernel vs plain on the same scenes: every
   gradient (template, warp, primpos, primrot, primscale) under a random
   cotangent from a seeded generator;
4. the render path at the full width of the flagship model
   (configs/config-synthetic-flagship.yaml: batch 4, 512x334 rays, 1024^2
   textures, 16384 primitives of 8^3, tile 16, max_hit 64, nbuf auto = 896,
   colorcal and background on), weights from a seeded generator: one warm-up
   forward with running_avg_scale=True, then one batch rendered self-id and
   cross-id as render.py does, under torch.inference_mode();
5. the training path at the same width and full depth: make_optimizer (Adam
   2e-4, clip 1.0) and make_train_step with the configuration's four loss
   weights; one warm-up step (running_avg_scale, ground-truth geometry,
   residuals off), three normal steps on different batches, a checkpoint
   saved before the last of them, restored, and that step taken again;
6. the training loop's entry point, train.loop.run (what ``python -m
   ava256_tpu_torch.train.loop`` calls), on the same configuration: two steps
   from scratch into a temporary directory, then a second call that finds
   the checkpoint there, resumes and takes one more;
7. forward kernel vs plain on the flagship scene, with the kernel's time, the
   plain version's time and the kernel's bound;
8. backward kernel vs plain on the flagship scene: the kernel over all tiles
   twice (the largest difference between the two runs is printed: its sums
   are floating-point atomics) and timed (mean of 5); the plain version on
   every BWD_PLAIN_STRIDE-th tile, against the kernel on the same tiles, both
   timed there too. The bound counts one evaluation of every sample the
   forward kernel counted plus the chain of every chained sample.

Tolerances, kernel vs plain. Forward: rtol = atol = 1e-5; both run the same
fp32 operations in the same order (the kernels are built without FMA
contraction); what is left is ulp-level rounding of expf and division.
Backward: max |d| <= BWD_TOL * max |ref| per gradient and cosine > 0.99999;
the kernel's sums over rays, rows and tiles are atomic adds in an order the
scheduler picks, the plain version's are index_add_ in another, so the two
differ by the rounding of fp32 sums of up to a few thousand terms.
The restored training step: loss terms within 1e-4 relative of the first
take, parameters within 2.1 learning rates (Adam's first steps move a
parameter by about lr * sign(g), and the backward's last bits are not
repeatable, so a gradient near zero may flip).

The second-to-last lines are the kernel table (JSON) and the card's name and
power limit; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import logging
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ava256_tpu_torch.data.synthetic import (
    SyntheticDataset, none_collate, raymarch_scene, synthetic_uvdata)
from ava256_tpu_torch.factory import get_autoencoder
from ava256_tpu_torch.flagship import FLAGSHIP  # configs/config-synthetic-flagship.yaml
from ava256_tpu_torch.ops import raymarch_cuda as rc
from ava256_tpu_torch.ops.cuda_lib import build_all
from ava256_tpu_torch.ops.math3d import rodrigues
from ava256_tpu_torch.render import BATCH_MODEL_KEYS, decode
from ava256_tpu_torch.train import loop
from ava256_tpu_torch.train.state import (
    TrainState, latest_checkpoint_step, make_optimizer, restore_checkpoint, save_checkpoint)
from ava256_tpu_torch.train.step import make_train_step

RTOL = ATOL = 1e-5
BWD_TOL = 2e-5  # backward kernel vs plain: max |d| / max |ref| per gradient
BWD_COS = 0.99999
BWD_PLAIN_STRIDE = 8  # the plain backward runs on every 8th tile of the flagship scene
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
# fp32 operations the kernel spends on one sample, counted from
# csrc/mvp_march_fwd.cu: row time, local point, box and range tests, fade
# (|y|^8 by squaring, exp), cell coordinates, 8-corner trilinear of 4
# channels, step-row accumulation. A warp adds a 3-channel trilinear.
OPS_PER_SAMPLE = 175
OPS_PER_WARP_SAMPLE = 85
# fp32 operations csrc/mvp_march_bwd.cu spends on one chained sample: the
# sample again (167), then the chain: the cotangents of its four channels
# (18), the 8-corner trilinear gradient of 4 channels with its adds into the
# gradient table (250), the fade's derivative (36), the ray position and the
# 12 affine terms (27). The function needs each sample once (as the forward
# evaluates it) and the chain; what the kernel's three marches spend beyond
# that (two more evaluations of every sample, a third of every chained one)
# is the design's cost and is printed beside the bound, not inside it.
OPS_PER_CHAINED_SAMPLE = 498
OPS_PER_CHAIN = OPS_PER_CHAINED_SAMPLE - 167


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


def check_grad(what: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """Backward tolerance: returns max |d| / max |ref|."""
    got, ref = got.double().cpu(), ref.double().cpu()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite gradient")
    top = float(ref.abs().max())
    if top == 0.0:
        raise AssertionError(f"{what}: the reference gradient is zero")
    err = float((got - ref).abs().max()) / top
    cos = float((got * ref).sum() / torch.sqrt((got * got).sum() * (ref * ref).sum()))
    if err > BWD_TOL or cos <= BWD_COS:
        raise AssertionError(f"{what}: max |d| / max |ref| {err:.3g} (limit {BWD_TOL}), "
                             f"cosine {cos:.8f} (limit {BWD_COS})")
    return err


# ---------------------------------------------------------------------------
# phase 3: small scenes
# ---------------------------------------------------------------------------

SMALL_CASES = [(2, False, 8, False), (4, True, 16, False), (8, True, 8, False),
               (8, False, 16, True), (16, False, 8, False)]


def small_scene(bs, warp, opaque):
    s = raymarch_scene(n=2, h=37, w=35, k3=3, bs=bs, warp=warp, seed=bs)
    if opaque:
        s["template"][..., 3] *= 30.0
    mask = (np.random.RandomState(0).rand(2, 27) > 0.3).astype(np.float32)
    return s, mask


def small_scenes_bwd(dev: torch.device) -> float:
    """Every gradient of the op, kernel (card) against plain (CPU tensors)."""
    worst = 0.0
    g = torch.randn((2, 37, 35, 4), generator=torch.Generator().manual_seed(3))
    for bs, warp, tile, opaque in SMALL_CASES:
        s, mask = small_scene(bs, warp, opaque)
        kw = dict(fadescale=8.0, fadeexp=8.0, tile=tile, max_hit=27, nbuf=64)
        grads = []
        for d in ("cpu", dev):
            t = {k: torch.from_numpy(np.array(v)).to(d) for k, v in s.items()
                 if isinstance(v, np.ndarray)}
            leaves = [t["primpos"], rodrigues(t["primrvec"]), t["primscale"], t["template"]]
            leaves += [t["warp"]] if warp else []
            leaves = [x.detach().requires_grad_() for x in leaves]
            out = rc.mvp_raymarch_cuda(
                t["raypos"], t["raydir"], s["stepsize"], t["tminmax"], *leaves[:4],
                leaves[4] if warp else None, prim_mask=torch.from_numpy(mask).to(d), device=d,
                **kw)
            (out * g.to(d)).sum().backward()
            grads.append([x.grad for x in leaves])
        torch.cuda.synchronize()
        names = ("primpos", "primrot", "primscale", "template", "warp")
        for name, ref, got in zip(names, *grads):
            worst = max(worst, check_grad(f"small scene bs={bs} warp={warp} d{name}", got, ref))
    return worst



def small_scenes(dev: torch.device) -> float:
    worst = 0.0
    for bs, warp, tile, opaque in SMALL_CASES:
        s, mask = small_scene(bs, warp, opaque)
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
            if k in BATCH_MODEL_KEYS or k in ("idindex", "camindex", "image")}


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
        for b in batches[1:2]:
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
    # and phases 7 and 8
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
    return model, ds, batches, out["march_inputs"], main_launches, float(np.mean(per_forward))


# ---------------------------------------------------------------------------
# phase 5: the flagship training path
# ---------------------------------------------------------------------------


def flagship_train(model, ds, batches, dev: torch.device):
    f = FLAGSHIP
    model.train()
    optimizer = make_optimizer(model, f["optimizer"], f["lr"], f["gamma"],
                               f["lr_scheduler_iter"], f["clip"])
    train_step = make_train_step(model, optimizer, dict(f["losses"]), ds.vertmean, ds.vertstd,
                                 output_set=frozenset(f["output_set"]))
    state = TrainState(model, optimizer, 0)
    decoders = {name: model.get_submodule(f"decoder_assembler.{name}")
                for name in ("rgbdec", "geodec")}
    warm = dict(running_avg_scale=True, use_gt_geo=True, residuals_weight=0.0)
    normal = dict(running_avg_scale=False, use_gt_geo=False, residuals_weight=1.0)
    steps = []

    def one_step(state, batch, flags):
        names = ("start", "forward", "backward", "optimizer")
        ev = {n: torch.cuda.Event(enable_timing=True) for n in names}
        before = (rc.march_tiles_kernel.launches, rc.march_tiles_bwd_kernel.launches)
        probe = next(decoders["rgbdec"].parameters())
        old = probe.detach().clone()
        ev["start"].record()
        state, total, terms = train_step(state, batch, mark=lambda n: ev[n].record(), **flags)
        torch.cuda.synchronize()
        rec = dict(step=state.step - 1, total=float(total),
                   terms={k: round(float(v), 5) for k, v in terms.items()},
                   ms=ev["start"].elapsed_time(ev["optimizer"]),
                   forward_ms=ev["start"].elapsed_time(ev["forward"]),
                   backward_ms=ev["forward"].elapsed_time(ev["backward"]),
                   optimizer_ms=ev["backward"].elapsed_time(ev["optimizer"]),
                   fwd_launches=rc.march_tiles_kernel.launches - before[0],
                   bwd_launches=rc.march_tiles_bwd_kernel.launches - before[1])
        vals = [rec["total"]] + list(rec["terms"].values())
        if not all(np.isfinite(v) for v in vals):
            raise AssertionError(f"step {rec['step']}: non-finite loss {rec}")
        if rec["fwd_launches"] < 1 or rec["bwd_launches"] < 1:
            raise AssertionError(f"step {rec['step']}: a march kernel was not launched: {rec}")
        for p_name, p in model.named_parameters():
            if p.grad is not None and not bool(torch.isfinite(p.grad).all()):
                raise AssertionError(f"step {rec['step']}: non-finite gradient of {p_name}")
        for name, dec in decoders.items():
            # with residuals_weight = 0 (warm-up) the motion heads are cut off
            dead = [n for n, p in dec.named_parameters()
                    if (p.grad is None or float(p.grad.abs().max()) == 0.0)
                    and not (flags["residuals_weight"] == 0.0 and n.startswith("motion"))]
            if dead:
                raise AssertionError(f"step {rec['step']}: zero gradient in {name}: {dead[:5]}")
        if torch.equal(old, probe.detach()):
            raise AssertionError(f"step {rec['step']}: the parameters did not change")
        steps.append(rec)
        return state

    torch.cuda.reset_peak_memory_stats(dev)
    rc.march_tiles_kernel.launches = 0  # the main path starts here
    rc.march_tiles_bwd_kernel.launches = 0
    state = one_step(state, batches[0], warm)
    state = one_step(state, batches[1], normal)
    state = one_step(state, batches[2], normal)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        save_checkpoint(ckpt_dir, state)
        state = one_step(state, batches[3], normal)
        first = steps[-1]
        after = [p.detach().clone() for p in model.parameters()]
        state = restore_checkpoint(ckpt_dir, state)
        if state.step != 3:
            raise AssertionError(f"restored step {state.step}, saved 3")
        state = one_step(state, batches[3], normal)
    launches = (rc.march_tiles_kernel.launches, rc.march_tiles_bwd_kernel.launches)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30  # the main path ends here

    again = steps[-1]
    for k, v in first["terms"].items():
        if abs(again["terms"][k] - v) > 1e-4 * abs(v) + 1e-6:
            raise AssertionError(f"restored step: {k} {again['terms'][k]} != {v}")
    drift = max(float((p.detach() - q).abs().max()) for p, q in zip(model.parameters(), after))
    if drift > 2.1 * f["lr"]:
        raise AssertionError(f"restored step: parameters differ by {drift}")
    aw = model.decoder_assembler.adaptwarps
    if not bool(torch.isfinite(aw).all()) or float(aw.min()) <= 0:
        raise AssertionError("adaptwarps not set by the warm-up step")
    normal_steps = steps[1:]
    mean = {k: float(np.mean([r[k] for r in normal_steps]))
            for k in ("ms", "forward_ms", "backward_ms", "optimizer_ms")}
    log("train", steps=len(steps), warmup_ms=round(steps[0]["ms"], 3),
        ms_per_step=round(mean["ms"], 3), forward_ms=round(mean["forward_ms"], 3),
        backward_ms=round(mean["backward_ms"], 3), optimizer_ms=round(mean["optimizer_ms"], 3),
        ms_each=[round(r["ms"], 3) for r in steps], peak_gib=round(peak_gib, 3),
        fwd_launches=launches[0], bwd_launches=launches[1],
        launches_per_step=[(r["fwd_launches"], r["bwd_launches"]) for r in steps],
        restored_step_param_drift=drift, lr=state.optimizer.schedule(state.step))
    for r in steps:
        log("train-step", step=r["step"], total=round(r["total"], 5), **r["terms"])
    model.eval()
    optimizer.zero_grad()
    return launches, mean["ms"]


# ---------------------------------------------------------------------------
# phase 6: the training loop's entry point
# ---------------------------------------------------------------------------


def flagship_loop(dev: torch.device):
    lines = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: lines.append(record.getMessage())
    loop.logger.addHandler(handler)
    loop.logger.setLevel(logging.INFO)
    rc.march_tiles_kernel.launches = 0  # this path starts here
    rc.march_tiles_bwd_kernel.launches = 0
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as out:
            ckpt_dir = Path(out) / "checkpoints"
            state = loop.run(FLAGSHIP, out=out, steps=2, device=dev)
            if state.step != 2 or latest_checkpoint_step(ckpt_dir) != 2:
                raise AssertionError(f"loop: step {state.step} after a run to step 2")
            kept = [p.detach().clone() for p in state.model.parameters()]
            del state
            state = loop.run(FLAGSHIP, out=out, steps=3, device=dev)
            if state.step != 3 or latest_checkpoint_step(ckpt_dir) != 3:
                raise AssertionError(f"loop: step {state.step} after resuming to step 3")
    finally:
        loop.logger.removeHandler(handler)
    launches = (rc.march_tiles_kernel.launches, rc.march_tiles_bwd_kernel.launches)
    seconds = time.perf_counter() - t0  # this path ends here
    if launches != (3, 3):
        raise AssertionError(f"loop: kernel launches {launches} in 3 steps")
    if not any("Resumed from" in ln and "step 2" in ln for ln in lines):
        raise AssertionError(f"loop: the second call did not resume: {lines}")
    losses = [float(m.group(1)) for ln in lines
              if (m := re.match(r"Iteration \d+ loss = (\S+),", ln))]
    if len(losses) != 3 or not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"loop: losses {losses}")
    params = list(state.model.parameters())
    if not all(bool(torch.isfinite(p).all()) for p in params):
        raise AssertionError("loop: non-finite parameters")
    if all(torch.equal(p.detach(), q) for p, q in zip(params, kept)):
        raise AssertionError("loop: the resumed step changed no parameter")
    log("loop", steps=3, resumed_at=2, losses=losses, fwd_launches=launches[0],
        bwd_launches=launches[1], seconds=round(seconds, 3))
    return launches


# ---------------------------------------------------------------------------
# phases 7 and 8: the kernels vs plain on the flagship scene
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
    return args, boxes, samples, dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                                      bound_ms=max(bytes_ms, ops_ms),
                                      bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def flagship_kernel_bwd(args, boxes: int, samples: int, dev: torch.device):
    """args: the forward kernel's arguments on the flagship scene; samples: the
    (ray, row, candidate) samples the forward counted there."""
    gid, scal, t_o, t_d, t_mm, tpl, warp, dt, fadescale, fadeexp, nbuf = args
    ntiles, mh = gid.shape
    t2 = t_o.shape[2]
    bs = tpl.shape[1]
    g = torch.randn((ntiles, 4, t2), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))

    every = (gid, scal, t_o, t_d, t_mm, g)
    sel = slice(0, ntiles, BWD_PLAIN_STRIDE)
    some = tuple(x[sel].contiguous() for x in every)

    def kernel(tiles=every, counts=None):
        return rc.march_tiles_bwd_kernel(*tiles, tpl, warp, dt, fadescale, fadeexp, nbuf,
                                         counts=counts)

    counts = {}
    with torch.inference_mode():
        run1 = kernel(counts=counts)
        run2 = kernel()
        rerun = max(float((a - b).abs().max() / a.abs().max())
                    for a, b in zip(run1, run2) if a is not None)
        for name, x in zip(("d_template", "d_warp", "d_affine"), run1):
            if x is not None and not bool(torch.isfinite(x).all()):
                raise AssertionError(f"flagship backward: non-finite {name}")
        del run2
        kernel_ms = cuda_ms(kernel, reps=5)
        sub = kernel(some)
        sub_ms = cuda_ms(lambda: kernel(some), reps=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = rc.march_tiles_bwd_plain(*some, tpl, warp, dt, fadescale, fadeexp, nbuf)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    errs = {name: check_grad(f"flagship backward {name}", a, b)
            for name, a, b in zip(("d_template", "d_warp", "d_affine"), sub, plain)
            if b is not None}

    fwd_samples, chained = int(counts["forward_samples"]), int(counts["chained_samples"])
    grad_tables = tpl.numel() * 4 + tpl.shape[0] * 12 * 4
    nbytes = (boxes * bs**3 * 4 * 4 + ntiles * mh * (4 + 12 * 4) + ntiles * t2 * 8 * 4
              + ntiles * 4 * t2 * 4 + grad_tables)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (samples * OPS_PER_SAMPLE + chained * OPS_PER_CHAIN) / FP32_OPS_PER_S * 1e3
    design_ops_ms = (fwd_samples * OPS_PER_SAMPLE + chained * OPS_PER_CHAINED_SAMPLE) \
        / FP32_OPS_PER_S * 1e3
    nsub = len(range(ntiles)[sel])
    log("flagship-kernel-bwd", tiles=ntiles, samples=samples, marched_samples=fwd_samples,
        chained_samples=chained, bytes=nbytes, kernel_ms=round(kernel_ms, 4),
        rerun_max_rel_diff=rerun, plain_tiles=nsub,
        plain_tiles_of=f"every {BWD_PLAIN_STRIDE}th tile",
        kernel_ms_on_those_tiles=round(sub_ms, 4), plain_ms_on_those_tiles=round(plain_ms, 3),
        bound_bytes_ms=round(bytes_ms, 5), bound_ops_ms=round(ops_ms, 5),
        three_march_ops_ms=round(design_ops_ms, 5),
        **{f"max_rel_err_{k}": v for k, v in errs.items()})
    return dict(max_abs_err=max(errs.values()), ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                tiles=ntiles, plain_tiles=nsub, ms_on_plain_tiles=sub_ms,
                three_march_ops_ms=design_ops_ms)


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
    libs = [rc.MARCH_FWD_LIB, rc.MARCH_BWD_LIB]
    build_all(libs)
    ptxas = [ln.strip() for lib in libs for ln in lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", seconds=round(time.perf_counter() - t0, 3), ptxas=ptxas)

    small_err = small_scenes(dev)
    log("small-scenes", max_abs_err=small_err)
    small_bwd_err = small_scenes_bwd(dev)
    log("small-scenes-bwd", max_rel_err=small_bwd_err, tol=BWD_TOL)

    model, ds, batches, mi, render_launches, fwd_ms = flagship_render(dev)
    train_launches, step_ms = flagship_train(model, ds, batches, dev)
    del model, batches
    torch.cuda.empty_cache()
    loop_launches = flagship_loop(dev)
    torch.cuda.empty_cache()
    args, boxes, samples, k = flagship_kernel(mi, dev)
    kb = flagship_kernel_bwd(args, boxes, samples, dev)

    src = "ava256_tpu_torch/csrc/"
    table = {"kernels": [
        dict(name="mvp_march_fwd", route="cuda", source=src + "mvp_march_fwd.cu",
             replaces="ava256_tpu/ops/raymarch_pallas.py:831",
             launches=render_launches + train_launches[0] + loop_launches[0],
             launches_render=render_launches, launches_train=train_launches[0],
             launches_loop=loop_launches[0], max_abs_err=max(small_err, k["max_abs_err"]),
             ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"],
             library_ms=None),
        dict(name="mvp_march_bwd", route="cuda", source=src + "mvp_march_bwd.cu",
             replaces="ava256_tpu/ops/raymarch_pallas.py:908",
             launches=train_launches[1] + loop_launches[1], launches_train=train_launches[1],
             launches_loop=loop_launches[1],
             max_abs_err=max(small_bwd_err, kb["max_abs_err"]), ms=kb["ms"],
             plain_ms=kb["plain_ms"], bound_ms=kb["bound_ms"], bound_by=kb["bound_by"],
             library_ms=None,
             # ms is the kernel on all tiles; plain_ms is the plain version on
             # plain_tiles of them, ms_on_plain_tiles the kernel on the same
             tiles=kb["tiles"], plain_tiles=kb["plain_tiles"],
             ms_on_plain_tiles=kb["ms_on_plain_tiles"],
             three_march_ops_ms=kb["three_march_ops_ms"])]}
    log("done", seconds=round(time.perf_counter() - t_start, 3), ms_per_forward=fwd_ms,
        ms_per_train_step=step_ms)
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
