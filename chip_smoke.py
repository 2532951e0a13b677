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
   saved before the last of them, restored, and that step taken again (its
   losses and parameters bitwise equal to the first take's);
5b. ``[grid-sample]``: the grid-sample kernels (``csrc/grid_sample.cu``)
   on every call of one training forward of that model (each level of both
   bias pyramids of the identity encoder's warp, batch 4, up to 1024^2, and
   the geometry decoder's vertex sampling), with the layouts the model
   hands them (channels-last where the convolutions run channels-last, the
   warp grid expanded over the batch, gout in the image's layout): the
   image gradient bitwise equal to ``grid_sample_bwd_fixed_plain`` at the
   kernel's scale, on a warp level the owner and scatter routes (each
   forced) bitwise equal, the device escape count 0 and equal to its plain
   restatement, the route the one its size picks; against
   ``F.grid_sample`` outputs at rtol = atol = 1e-5, gradients at the
   backward limits; a rerun bitwise equal; at most 5 kernels a warp level's
   backward; printed: each call's forward and backward ms, route and
   backward kernels (``[grid-sample-call]``), the kernels' forward +
   backward ms over those calls beside F.grid_sample's and its plain
   version's, and the bytes bound; the traced steps of the training phases
   print the grid-sample kernels' count and ms;
5c. ``[traceprof]``: ``python -m ava256_tpu_torch.traceprof``'s traced
   step on that model (the warm-up step, a normal one, then one more traced
   with Python stacks and a scope per module) and its aggregation: at least
   95 % of the step's device time on a source line of the package, one
   launch of each march kernel a step; printed: that share, the 10 largest
   source lines and modules, and the modules and lines that own the
   conv-gradient kernels (``*wgrad*``, ``*dgrad*``);
6. the training entry point, ``cli.train.main`` (what ``python -m
   ava256_tpu_torch.cli.train`` runs) on configs/config-synthetic-flagship.yaml
   with a topology .obj written into a temporary ``assets=`` directory: two
   steps from scratch (step 1 traced by torch.profiler), then a second call
   that finds the checkpoint, resumes and takes one more. Checked: one launch
   of each kernel per step, the backward handed the forward's state, the
   device tables and lean batches handed to every step, no training batch
   from the held-out cameras 8 and 9, the resume, finite losses, changed
   parameters, progress_0.png and x-id/progress_0.png of the expected sizes,
   the trace (its ``train_step`` span) and timesinfo_r0.npy; printed: the UV
   build's seconds, the progress render's ms and each step's StepTimer ms
   (each is the first of its call or traced);
6b. the inference entry points on that run's checkpoint: ``cli.eval
   --holdout-cameras 2 --num-items 4`` (finite psnr_db, ssim, lpips_rf on the
   held-out split), ``cli.render --num-frames 2`` (two PNGs) and
   ``cli.generate_id_cond`` (one pickle per identity);
6c. steady steps of the training entry point: ``cli.train`` from that
   checkpoint to step 10 with the warm-up switches on up to step 6 and step
   7 traced; printed: the StepTimer p50 of untraced steps that are not the
   first of their call, warm-up and normal;
6c'. ``model.dtype=bfloat16`` on the flagship: ``[bf16-train]`` runs
   ``cli.train`` as phases 6 and 6c together (2 steps from scratch, then a
   resume to step 10, step 7 traced; one launch of each kernel per step, a
   bfloat16 model with float32 parameters, finite losses, moved parameters;
   the kernels refuse any input but float32 and int32); ``[bf16-cli]`` runs
   ``cli.eval``, ``cli.render`` and ``cli.generate_id_cond`` on its
   checkpoint; ``[dtype-turns]`` resumes the float32 and the bfloat16 step-10
   checkpoints for 12 more steps each, in the order fp32, bf16, bf16, fp32,
   and prints each dtype's StepTimer p50 over 22 steps;
6d. the capture-data path (``configs/config-4.yaml``): ``[capture-write]``
   writes 4 identities of the synthetic dataset as captures in the ava-256
   release's on-disk layout (``data.synthetic.write_capture``: 4 cameras,
   3 frames, 4096x2668 camera PNGs (the 512x334 render enlarged x8 by nearest
   neighbour, cropped; zlib level 1, filter 0), 1024^2 UV textures, PLYs of
   7,306 vertices) and prints the bytes and seconds; ``[capture-io]`` times
   one item's fetch on this host (zip read, inflate, unfilter, resize, PLY)
   and holds the host library's resize against its numpy restatement on one
   4096x2668 image (at most one level apart); ``[loaderbench]`` runs
   ``python -m ava256_tpu_torch.loaderbench --frames 12 --items 24`` (the
   port of scripts/loaderbench.py: ShardedLoader items/s with 1, 2 and 4
   threads on 4096x2668 PNG captures); ``[capture-train]`` runs
   ``cli.train`` on config-4 (batch 4, 512x333 rays, 16,384 primitives of
   8^3, tile 16, max_hit 128, 4 loader threads) over those captures: 2 steps
   from scratch, then a resume to step 8 with step 5 traced. Checked: one
   launch of each kernel per step, the backward handed the forward's state,
   4 items in every batch and no failed fetch, finite losses, changed
   parameters, the progress PNGs at the dataset's 512x333; printed: the
   StepTimer p50 of untraced steps that are not the first of their call
   (all are warm-up steps: config-4 keeps the switches on for 100), the two
   march kernels' ms in the trace and the peak GiB, beside the flagship's
   ``[loop-steady]`` numbers; ``[capture-cli]`` runs ``cli.eval
   --holdout-cameras 1 --num-items 2``, ``cli.render --num-frames 1`` and
   ``cli.generate_id_cond`` on that checkpoint; ``[demos]`` (after
   ``[capture-write]``) adds a small ``keypoints_3d.zip`` and
   ``segmentation_parts.zip`` to the first capture, which ``write_capture``
   does not write, runs ``python -m ava256_tpu_torch.demos.{walkthrough,
   keypoints,mesh,segmentation}`` on it as four child processes side by
   side (a failed demo fails the run) and prints each one's seconds and its
   PNG's height and width;
6e. data-parallel training on configs/config-synthetic-262k.yaml (batch 4,
   512x334 rays, 1024^2 textures, 262,144 primitives of 2^3: the two-stage
   cull, both kernels at bs 2, the table scale 128 and motion_size 512):
   ``[ddp-train]`` runs ``cli.train`` in this process for 3 steps, then
   ``python -m torch.distributed.run --standalone --nproc_per_node 1
   chip_smoke.py --train-child OUT -- ARGS`` twice (``mesh.multihost=true``: 2
   steps, then a resume to 3); the launched process runs ``cli.train.main``
   (what ``-m ava256_tpu_torch.cli.train`` runs) with its steps watched and
   writes what it saw to OUT. Checked: NCCL with a world of 1, the group
   left at the end, one gradient all-reduce and one launch of each kernel
   per step, the resume, every loss equal to the single process's exactly;
   printed: the losses, the StepTimer ms and p50 of the steps that are not
   first in their call, the peak GiB of each process, the seconds;
   ``[262k-kernel]`` and ``[262k-kernel-bwd]`` hold the two kernels against
   their plain versions on that configuration's scene (a batch rendered by
   the model ``[ddp-train]`` trained), as phases 7 and 8 do on the
   flagship's: the forward on every tile, the backward with the forward's
   state on every 8th;
7. forward kernel vs plain on the flagship scene, its second output (the
   rays' saturation state, which the training step saves for the backward)
   included, with the kernel's time with and without that output, the plain
   version's time and the kernel's bound;
8. backward kernel vs plain on the flagship scene: the kernel over all tiles
   twice (the two runs must be bitwise equal: its sums are order-free
   integer sums; each template channel's headroom_bits is printed) and
   timed (mean of 5) as the training step calls it, with the forward's
   saved state, and without one (the wrapper
   then runs the forward kernel first); the plain version on every
   BWD_PLAIN_STRIDE-th tile, against the kernel on the same tiles, both
   timed there too. The bound counts one evaluation of every sample the
   plain forward counted plus the chain of every chained sample.
8b. ``[fwdprof]``: ``python -m ava256_tpu_torch.fwdprof``'s split of the
   forward march op on kbench's shell scene (cull, the template table, the
   affines, the kernel with and without the state, untile, the whole op, each
   timed alone); the parts composed must give the op's output bit for bit.

9. ``[xla-march]``: the compacted marcher (``ops/raymarch_xla.py``, plain
   PyTorch: no kernel of its own) at full width on kbench's shell scene (4 x
   512x334 rays, 16,384 primitives of 8^3), held to the CUDA kernels by
   ``kbench.compare_with_kernels`` once max_hit and max_samples are raised
   until both march the same samples (no culled tile full, no ray over its
   budget); timed beside the CUDA op at the same settings, with the rays that
   overflow at the flagship's max_hit 64 and max_samples 96 printed;
   ``[xla-262k]``: whether it fits at 262,144 primitives of 2^3 (a forward,
   then forward + backward; an out-of-memory error is reported);
10. ``[xla-train]``: ``cli.train`` on the flagship yaml with
   ``model.raymarch.backend=xla`` for 2 steps (finite losses, moved
   parameters, no march kernel launched); ``[repeat]``: one normal step
   taken twice from one state on one batch, from the float32, bfloat16 and
   ``backend: xla`` checkpoints of the phases before: every loss term,
   gradient, parameter and Adam moment bitwise equal, or the phase fails;
   ``[resume-exact]``: ``cli.train`` on the flagship to step 8 with a
   checkpoint every 4 steps, and a second run from that mid-run checkpoint to
   step 8: the two step-8 checkpoints and the re-logged losses bitwise
   equal;
   ``[long-recipe]``: ``python -m ava256_tpu_torch.flagship_runs`` with
   the reference's round-5 recipe at a small horizon (bf16, 12 steps, the
   StepLR bump at 8, a checkpoint every 4, SIGKILL in step 11, the resume
   from the checkpoint after step 8; each ``cli.train`` process this
   script's ``--train-child``): the run's exit code, steps 9 and 10 re-logged
   with equal losses, lr 2.8e-4 from the bump, one launch of each kernel a
   step in the resumed process; ``[latent]``: ``cli.train`` of the flagship
   in bfloat16 for steps 0-60, the KL term and the bottleneck's largest |mu|
   at steps 18, 30, 45 and 60 and the median KL of steps 40-60 printed;
11. ``[bench]``: ``python -m ava256_tpu_torch.bench`` at its defaults in a
   child process, its JSON line printed under the tag (bench.py's keys,
   finite values, one launch of each kernel per train step), then
   ``[kbench]``: ``python -m ava256_tpu_torch.kbench --verify``.

Tolerances, kernel vs plain. Forward: rtol = atol = 1e-5; both run the same
fp32 operations in the same order (the kernels are built without FMA
contraction); what is left is ulp-level rounding of expf and division.
Backward: max |d| <= BWD_TOL * max |ref| per gradient and cosine > 0.99999;
the kernel's sums over rays, rows and tiles are integer sums at a
fixed-point scale (exact and order-free, so two runs give the same bits:
rerun_max_rel_diff must be 0), the plain version's are float index_add_ in
another order, so the two differ by the rounding of fp32 sums of up to a
few thousand terms and the fixed point's resolution (headroom_bits).
The compacted marcher vs the kernels (the same samples): alpha at rtol =
atol = 1e-4 on every ray; the images of the rays that saturate in neither
(the two composite a saturating step by different rules) to 1e-4 of their
largest value plus 1e-4; the gradients of a cotangent on those rays at
cosine > 0.9999, the template's also at max |d| <= 1e-3 max |ref|. The two
round a sample's place in its box differently, so a sample on a box face
can be taken by one only; the geometric gradients' max |d| and the
primitives beyond 1e-3 are printed as measured.
Repeats: the restored training step, [ddp-train], [repeat] and
[resume-exact] are held to bitwise equality (every path that builds the
model runs under PyTorch's deterministic mode, and the kernels' sums are
order-free). The plain versions on the card run outside that mode: they are
checks, not the main path.

The second-to-last lines are the kernel table (JSON) and the card's name and
power limit; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import logging
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
import zipfile
from pathlib import Path

import numpy as np
import torch

from ava256_tpu_torch import flagship_runs, fwdprof, kbench, native, parallel, traceprof
from ava256_tpu_torch.cli import eval as cli_eval
from ava256_tpu_torch.cli import generate_id_cond as cli_idc
from ava256_tpu_torch.cli import render as cli_render
from ava256_tpu_torch.cli import train as cli_train
from ava256_tpu_torch.config import load_config
from ava256_tpu_torch.data.dataset import MultiCaptureDataset, _zip_read, train_csv_loader
from ava256_tpu_torch.data.loader import Uploader
from ava256_tpu_torch.data.png import decode_png
from ava256_tpu_torch.data.synthetic import (
    SyntheticDataset, none_collate, raymarch_scene, synthetic_uvdata, write_capture,
    write_topology_obj)
from ava256_tpu_torch.factory import get_autoencoder
from ava256_tpu_torch.flagship import FLAGSHIP  # configs/config-synthetic-flagship.yaml
from ava256_tpu_torch.geometry.ply import parse_ply_vertices
from ava256_tpu_torch.ops import fixed_point, graphs
from ava256_tpu_torch.ops import grid_sample as gs
from ava256_tpu_torch.ops import raymarch_cuda as rc
from ava256_tpu_torch.ops.cuda_lib import build_all
from ava256_tpu_torch.ops.math3d import rodrigues
from ava256_tpu_torch.ops.raymarch_xla import march_compacted
from ava256_tpu_torch.render import BATCH_MODEL_KEYS, decode
from ava256_tpu_torch.train import loop
from ava256_tpu_torch.train.profiling import TRACE_FILE, StepTimer
from ava256_tpu_torch.train.state import (
    TrainState, latest_checkpoint_step, make_optimizer, restore_checkpoint, save_checkpoint)
from ava256_tpu_torch.train.step import make_train_step, step_generator
from ava256_tpu_torch.utils import png_bytes

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
# evaluates it) and the chain; what the kernel's two marches spend beyond
# that (a second evaluation of every chained sample) is the design's cost and
# is printed beside the bound (two_march_ops_ms), not inside it.
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


def march_launches():
    """(forward kernel launches, backward kernel launches, those of the
    backward that were handed the forward's saved state)."""
    return (rc.march_tiles_kernel.launches, rc.march_tiles_bwd_kernel.launches,
            rc.march_tiles_bwd_kernel.launches_with_state)


def reset_march_launches() -> None:
    """Every kernel's count to 0 (the march kernels' and the grid-sample ones')."""
    rc.march_tiles_kernel.launches = 0
    rc.march_tiles_bwd_kernel.launches = rc.march_tiles_bwd_kernel.launches_with_state = 0
    reset_grid_launches()


# the grid-sample kernels' (forward, backward) launches of each main path,
# read where the path ends (the march kernels' are returned by the phases)
GRID_LAUNCHES = {}


# backward calls of the main paths read by grid_launches(), by route, and the
# kernels they launched
GRID_ROUTES = dict(owner=0, scatter=0, bwd_kernels=0)


def grid_launches() -> tuple:
    k = gs.grid_sample_kernels
    GRID_ROUTES["owner"] += k.owner_launches
    GRID_ROUTES["scatter"] += k.scatter_launches
    GRID_ROUTES["bwd_kernels"] += k.bwd_kernels
    return k.launches, k.bwd_launches


def reset_grid_launches() -> None:
    gs.grid_sample_kernels.reset()


@contextlib.contextmanager
def plain_check():
    """The plain versions on the card are checks, not the main path: they run
    outside the deterministic mode (under it, index_add_ sorts, and the
    backward's plain version takes minutes)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


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
    upload = Uploader(dev)
    batches = [upload.now(loop.to_model_batch(none_collate([ds[b * f["nident"] + i]
                                                            for i in range(bsz)])))
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
    reset_grid_launches()
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
    GRID_LAUNCHES["flagship_render"] = grid_launches()
    graph_counts = graphs.report(model)  # captures and replays of the main path
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
        alpha_coverage=round(coverage, 4), self_vs_cross_mean_abs=round(self_cross, 3),
        graphs=graph_counts)
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
        before = march_launches()
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
                   **{k: now - was for k, now, was in zip(
                       ("fwd_launches", "bwd_launches", "bwd_with_state"), march_launches(),
                       before)})
        vals = [rec["total"]] + list(rec["terms"].values())
        if not all(np.isfinite(v) for v in vals):
            raise AssertionError(f"step {rec['step']}: non-finite loss {rec}")
        if rec["fwd_launches"] < 1 or rec["bwd_launches"] < 1:
            raise AssertionError(f"step {rec['step']}: a march kernel was not launched: {rec}")
        if (rec["fwd_launches"], rec["bwd_with_state"]) != (1, rec["bwd_launches"]):
            raise AssertionError(f"step {rec['step']}: the backward was not handed the forward's "
                                 f"saved state (or marched the forward again): {rec}")
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
    reset_march_launches()  # the main path starts here
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
    launches = march_launches()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30  # the main path ends here
    GRID_LAUNCHES["flagship_train"] = grid_launches()

    again = steps[-1]
    if (again["total"], again["terms"]) != (first["total"], first["terms"]):
        raise AssertionError(f"restored step: losses {again} != {first}")
    drift = max(float((p.detach() - q).abs().max()) for p, q in zip(model.parameters(), after))
    if drift != 0.0:
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
        fwd_launches=launches[0], bwd_launches=launches[1], bwd_with_state=launches[2],
        launches_per_step=[(r["fwd_launches"], r["bwd_launches"]) for r in steps],
        restored_step_param_drift=drift, lr=state.optimizer.schedule(state.step))
    for r in steps:
        log("train-step", step=r["step"], total=round(r["total"], 5), **r["terms"])
    model.eval()
    optimizer.zero_grad()
    return launches, mean["ms"]


# ---------------------------------------------------------------------------
# phase 6: the training entry point; phase 6b: the inference entry points
# ---------------------------------------------------------------------------

FLAGSHIP_YAML = "configs/config-synthetic-flagship.yaml"


class LogLines(logging.Handler):
    """Collects the messages of the root logger while it is attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        logging.getLogger().addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger().removeHandler(self)


def png_size(path) -> tuple:
    """(height, width, channels) of an 8-bit non-interlaced PNG, after checking
    every chunk's CRC and that the image data inflates to its size."""
    import struct
    import zlib

    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise AssertionError(f"{path}: bad CRC in {tag}")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    c = {0: 1, 2: 3, 6: 4}[ctype]
    if depth != 8 or len(zlib.decompress(idat)) != h * (1 + w * c):
        raise AssertionError(f"{path}: image data does not match its header")
    return h, w, c


class Watched:
    """While entered, ``loop.run``'s steps and step timers are watched: each
    step's launches (host-side counters) and its batch's index tensors are
    kept, and read only after the run, so the watch adds no device sync
    inside the timed step; each StepTimer is kept for its per-step times."""

    def __init__(self, cached=("avgtex",)):
        self.steps, self.timers = [], []  # (idindex, camindex, launches) per step
        self.losses = []  # each step's returned loss, as floats after the run
        self.cached = cached  # fields the device tables hold, which a lean batch lacks

    def __enter__(self):
        make, steps, timers, losses = (loop.make_train_step, self.steps, self.timers,
                                       self.losses)

        def counting_make_train_step(*args, **kwargs):
            step = make(*args, **kwargs)

            def counted(state, batch, **kw):
                if kw.get("cond") is None or any(k in batch for k in self.cached):
                    raise AssertionError("loop: the step was not handed the device tables and "
                                         "a lean batch")
                before = march_launches()
                out = step(state, batch, **kw)
                steps.append((batch["idindex"], batch["camindex"],
                              tuple(b - a for a, b in zip(before, march_launches()))))
                losses.append(out[1])
                return out

            return counted

        class KeptTimer(StepTimer):
            def __init__(self):
                super().__init__()
                timers.append(self)

        self.saved = loop.make_train_step, loop.StepTimer
        loop.make_train_step, loop.StepTimer = counting_make_train_step, KeptTimer
        return self

    def __exit__(self, *exc):
        loop.make_train_step, loop.StepTimer = self.saved
        self.steps[:] = [(i.tolist(), c.tolist(), n) for i, c, n in self.steps]
        self.losses[:] = [float(x) for x in self.losses]

    def ms(self, call: int) -> list:
        """StepTimer ms of every step of the call-th run."""
        return [round(t * 1e3, 3) for t in self.timers[call].times]

    def launches(self) -> tuple:
        return tuple(sum(s[2][i] for s in self.steps) for i in range(3))


def flagship_loop(dev: torch.device, work: Path, train_ms_per_step: float):
    """cli.train on the flagship yaml: 2 steps from scratch (step 1 traced),
    then a second call that resumes and takes one more."""
    assets, run_dir = work / "assets", work / "run"
    write_topology_obj(assets / "face_topology.obj")
    argv = ["--config", FLAGSHIP_YAML, "--device", str(dev), f"assets={assets}",
            f"progress.output_path={run_dir}", "progress.profile_at=1"]
    ckpt_dir = run_dir / "checkpoints"
    reset_march_launches()  # this path starts here
    t0 = time.perf_counter()
    with LogLines() as log_lines, Watched() as watched:
        state = cli_train.main(argv + ["train.maxiter=2"])
        if state.step != 2 or latest_checkpoint_step(ckpt_dir) != 2:
            raise AssertionError(f"loop: step {state.step} after a run to step 2")
        kept = [p.detach().clone() for p in state.model.parameters()]
        if not (run_dir / "timesinfo_r0.npy").is_file():
            raise AssertionError("loop: no timesinfo_r0.npy")
        del state
        state = cli_train.main(argv + ["train.maxiter=3"])
        if state.step != 3 or latest_checkpoint_step(ckpt_dir) != 3:
            raise AssertionError(f"loop: step {state.step} after resuming to step 3")
        timing = np.load(run_dir / "timesinfo_r0.npy", allow_pickle=True).item()
    launches = march_launches()
    seconds = time.perf_counter() - t0  # this path ends here
    GRID_LAUNCHES["flagship_loop"] = grid_launches()
    lines, steps = log_lines.lines, watched.steps
    step_launches = watched.launches()
    if timing["steps"] != 1 or watched.ms(1) != [round(timing["p50_s"] * 1e3, 3)]:
        raise AssertionError(f"loop: timesinfo {timing} against the step timer {watched.ms(1)}")
    if step_launches != (3, 3, 3) or len(steps) != 3:
        raise AssertionError(f"loop: kernel launches {step_launches} in {len(steps)} steps")
    cams = sorted({c for s in steps for c in s[1]})
    if set(cams) & {8, 9}:
        raise AssertionError(f"loop: a training batch holds a held-out camera: {cams}")
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
    f = FLAGSHIP
    if png_size(run_dir / "progress_0.png") != (f["batch"] * f["height"], 3 * f["width"], 3):
        raise AssertionError(f"loop: progress_0.png is {png_size(run_dir / 'progress_0.png')}")
    id0 = steps[0][0][0]
    ncross = len([i for i in range(min(3, f["nident"])) if i != id0])
    xid = png_size(run_dir / "x-id" / "progress_0.png")
    if xid != (f["height"], (2 + ncross) * f["width"], 3):
        raise AssertionError(f"loop: x-id/progress_0.png is {xid}")
    events = json.loads((run_dir / "profile" / TRACE_FILE).read_text())["traceEvents"]
    if not any(e.get("name") == "train_step" and e.get("cat") == "user_annotation"
               for e in events):
        raise AssertionError("loop: no train_step span in the traced step's trace")
    uv_s = [float(m.group(1)) for ln in lines
            if (m := re.match(r"UV maps at \d+\^2 ready \((\S+) s\)", ln))]
    render_ms = [float(m.group(1)) for ln in lines
                 if (m := re.search(r"Progress iter 0: .*\((\S+) ms\)", ln))]
    log("loop", steps=3, resumed_at=2, losses=losses, fwd_launches=launches[0],
        bwd_launches=launches[1], bwd_with_state=launches[2], step_launches=step_launches,
        train_cameras=cams, seconds=round(seconds, 3))
    # step 0 and step 2 are the first of their call, step 1 is traced: none
    # of these is a steady step (see the [loop-steady] phase)
    log("loop-times", uv_build_s=uv_s[0], uv_cached_s=uv_s[1:], progress_render_ms=render_ms,
        steptimer_ms_step_0_first=watched.ms(0)[0], steptimer_ms_step_1_traced=watched.ms(0)[1],
        steptimer_ms_step_2_first=watched.ms(1)[0], train_ms_per_step=round(train_ms_per_step, 3))
    return launches


LOOP_END = 3  # phase 6's last checkpoint
STEADY_WARMUP, STEADY_TRACED, STEADY_END = 6, 7, 10


def flagship_loop_steady(dev: torch.device, work: Path, train_ms_per_step: float):
    """cli.train from phase 6's checkpoint (step 3) to step 10 in a new
    output directory, with the warm-up switches on up to step 6 (the
    flagship's are on for 100 steps; most of a run is after them): steps 4
    and 5 are steady warm-up steps, 8 and 9 steady normal steps, step 7 is
    traced."""
    run_dir = work / "steady"
    argv = ["--config", FLAGSHIP_YAML, "--device", str(dev), f"assets={work / 'assets'}",
            f"progress.output_path={run_dir}", f"train.checkpoint={work / 'run' / 'checkpoints'}",
            f"train.warmup_iters={STEADY_WARMUP}", f"progress.profile_at={STEADY_TRACED}",
            f"train.maxiter={STEADY_END}"]
    reset_march_launches()  # this path starts here
    with Watched() as watched:
        state = cli_train.main(argv)
    launches = march_launches()  # this path ends here
    GRID_LAUNCHES["flagship_loop_steady"] = grid_launches()
    n = STEADY_END - LOOP_END
    if state.step != STEADY_END or watched.launches() != (n, n, n) or launches != (n, n, n):
        raise AssertionError(f"loop-steady: step {state.step}, launches {launches}")
    if set(c for s in watched.steps for c in s[1]) & {8, 9}:
        raise AssertionError("loop-steady: a training batch holds a held-out camera")
    ms = dict(zip(range(LOOP_END, STEADY_END), watched.ms(0)))
    warm = [ms[i] for i in range(LOOP_END + 1, STEADY_WARMUP)]
    normal = [ms[i] for i in range(STEADY_TRACED + 1, STEADY_END)]
    log("loop-steady", steps=n, steptimer_ms=ms, first=LOOP_END, traced=STEADY_TRACED,
        warmup_until=STEADY_WARMUP, steptimer_p50_ms_warmup=round(float(np.median(warm)), 3),
        steptimer_p50_ms_normal=round(float(np.median(normal)), 3),
        train_ms_per_step=round(train_ms_per_step, 3), fwd_launches=launches[0],
        bwd_launches=launches[1], bwd_with_state=launches[2])
    return launches, dict(p50_ms_warmup=round(float(np.median(warm)), 3),
                          p50_ms_normal=round(float(np.median(normal)), 3),
                          march_ms=trace_march_ms(run_dir / "profile" / TRACE_FILE))


def flagship_cli(dev: torch.device, work: Path):
    """cli.eval on the held-out cameras, cli.render and cli.generate_id_cond
    on the checkpoint of phase 6."""
    common = ["--config", FLAGSHIP_YAML, "--device", str(dev),
              "--checkpoint", str(work / "run" / "checkpoints")]
    opts = ["--opts", f"assets={work / 'assets'}"]
    reset_march_launches()  # this path starts here
    t0 = time.perf_counter()
    with LogLines() as log_lines:
        result = cli_eval.main(common + ["--holdout-cameras", "2", "--num-items", "4"] + opts)
        rendered = cli_render.main(common + ["--num-frames", "2", "--output",
                                             str(work / "renders")] + opts)
        names = cli_idc.main(common + ["--output", str(work / "id_conds")] + opts)
    launches = march_launches()
    seconds = time.perf_counter() - t0  # this path ends here
    GRID_LAUNCHES["flagship_cli"] = grid_launches()
    if result["split"] != "heldout_cameras" or result["items"] != 4 or not all(
            np.isfinite(result[k]) for k in ("psnr_db", "ssim", "lpips_rf")):
        raise AssertionError(f"cli.eval: {result}")
    f = FLAGSHIP
    pngs = sorted((work / "renders").glob("render_*.png"))
    if rendered != 2 or len(pngs) != 2 or any(
            png_size(p) != (f["height"], 3 * f["width"], 3) for p in pngs):
        raise AssertionError(f"cli.render: {rendered} frames, files {pngs}")
    pkls = sorted((work / "id_conds").glob("*.pkl"))
    if len(pkls) != f["nident"] or len(names) != f["nident"]:
        raise AssertionError(f"cli.generate_id_cond: {pkls}")
    with open(pkls[0], "rb") as fh:
        id_cond = pickle.load(fh)
    if id_cond["z_geo"].shape != (1, 4, 4, 16) or not np.isfinite(id_cond["z_geo"]).all():
        raise AssertionError(f"cli.generate_id_cond: z_geo {id_cond['z_geo'].shape}")
    if launches != (4 + 2 * 2, 0, 0):  # 4 eval items, 2 frames of 2 decodes
        raise AssertionError(f"cli: kernel launches {launches}")
    per_item = [float(m.group(1)) for ln in log_lines.lines
                if (m := re.search(r"Evaluated \d+ items: (\S+) ms per item", ln))]
    log("cli", eval=json.dumps(result), eval_ms_per_item=per_item[0], render_pngs=len(pngs),
        id_conds=len(pkls), fwd_launches=launches[0], bwd_launches=launches[1],
        seconds=round(seconds, 3))
    return launches


# ---------------------------------------------------------------------------
# phase 6c': model.dtype bfloat16 on the flagship
# ---------------------------------------------------------------------------

BF16_OPTS = ["model.dtype=bfloat16"]
BF16_END = 10


def bf16_train(dev: torch.device, work: Path, steady_fp32: dict):
    """cli.train on the flagship yaml with model.dtype=bfloat16 at full width:
    two steps from scratch, then a resume to step 10 with the warm-up
    switches on up to step 6 and step 7 traced, as [loop-steady] (float32)
    takes them in this call. Checked: a bfloat16 model with float32
    parameters, one launch of each kernel per step with the backward handed
    the forward's state, finite losses, changed parameters, the resume. The
    kernels take float32 (and int32) only: ``raymarch_cuda._check_tiles``
    refuses anything else, so a bfloat16 leak into the march fails here."""
    run_dir = work / "bf16"
    argv = ["--config", FLAGSHIP_YAML, "--device", str(dev), f"assets={work / 'assets'}",
            f"progress.output_path={run_dir}", f"train.warmup_iters={STEADY_WARMUP}",
            f"progress.profile_at={STEADY_TRACED}"] + BF16_OPTS
    torch.cuda.reset_peak_memory_stats(dev)
    reset_march_launches()  # this path starts here
    t0 = time.perf_counter()
    with LogLines() as log_lines, Watched() as watched:
        state = cli_train.main(argv + ["train.maxiter=2"])
        kept = [p.detach().clone() for p in state.model.parameters()]
        del state
        state = cli_train.main(argv + [f"train.maxiter={BF16_END}"])
    launches = march_launches()
    seconds = time.perf_counter() - t0  # this path ends here
    GRID_LAUNCHES["bf16_train"] = grid_launches()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    model = state.model
    if {m.dtype for m in model.modules() if hasattr(m, "dtype")} != {torch.bfloat16} or {
            p.dtype for p in model.parameters()} != {torch.float32}:
        raise AssertionError("bf16-train: not a bfloat16 model with float32 parameters")
    # the forward kernel also renders step 0's progress PNGs
    if state.step != BF16_END or watched.launches() != (BF16_END,) * 3 \
            or launches[1:] != (BF16_END,) * 2 or any(s[2] != (1, 1, 1) for s in watched.steps):
        raise AssertionError(f"bf16-train: step {state.step}, launches {launches}, per step "
                             f"{[s[2] for s in watched.steps]}")
    if not any("Resumed from" in ln and "step 2" in ln for ln in log_lines.lines):
        raise AssertionError("bf16-train: the second call did not resume at step 2")
    losses = watched.losses
    params = list(model.parameters())
    if len(losses) != BF16_END or not all(np.isfinite(v) for v in losses) or not all(
            bool(torch.isfinite(p).all()) for p in params):
        raise AssertionError(f"bf16-train: losses {losses}")
    if all(torch.equal(p.detach(), q) for p, q in zip(params, kept)):
        raise AssertionError("bf16-train: the resumed steps changed no parameter")
    ms = dict(zip(range(2, BF16_END), watched.ms(1)))
    warm = [ms[i] for i in range(3, STEADY_WARMUP)]
    normal = [ms[i] for i in range(STEADY_TRACED + 1, BF16_END)]
    p50_normal = float(np.median(normal))
    log("bf16-train", steps=BF16_END, resumed_at=2, losses=[round(v, 4) for v in losses],
        steptimer_ms=ms, steptimer_p50_ms_warmup=round(float(np.median(warm)), 3),
        steptimer_p50_ms_normal=round(p50_normal, 3),
        fp32_steptimer_p50_ms_warmup=steady_fp32["p50_ms_warmup"],
        fp32_steptimer_p50_ms_normal=steady_fp32["p50_ms_normal"],
        peak_gib=round(peak_gib, 3),
        fwd_launches=launches[0], bwd_launches=launches[1], bwd_with_state=launches[2],
        seconds=round(seconds, 3))
    return launches


def bf16_cli(dev: torch.device, work: Path):
    """cli.render --num-frames 1, cli.eval --holdout-cameras 2 --num-items 2
    and cli.generate_id_cond on [bf16-train]'s checkpoint, the model built in
    bfloat16."""
    common = ["--config", FLAGSHIP_YAML, "--device", str(dev),
              "--checkpoint", str(work / "bf16" / "checkpoints")]
    opts = ["--opts", f"assets={work / 'assets'}"] + BF16_OPTS
    reset_march_launches()  # this path starts here
    result = cli_eval.main(common + ["--holdout-cameras", "2", "--num-items", "2"] + opts)
    rendered = cli_render.main(common + ["--num-frames", "1", "--output",
                                         str(work / "bf16_renders")] + opts)
    names = cli_idc.main(common + ["--output", str(work / "bf16_id_conds")] + opts)
    launches = march_launches()  # this path ends here
    GRID_LAUNCHES["bf16_cli"] = grid_launches()
    if result["items"] != 2 or not all(np.isfinite(result[k])
                                       for k in ("psnr_db", "ssim", "lpips_rf")):
        raise AssertionError(f"bf16 cli.eval: {result}")
    f = FLAGSHIP
    pngs = sorted((work / "bf16_renders").glob("render_*.png"))
    if rendered != 1 or len(pngs) != 1 or png_size(pngs[0]) != (f["height"], 3 * f["width"], 3):
        raise AssertionError(f"bf16 cli.render: {rendered} frames, files {pngs}")
    pkls = sorted((work / "bf16_id_conds").glob("*.pkl"))
    with open(pkls[0], "rb") as fh:
        id_cond = pickle.load(fh)
    z = id_cond["z_geo"]
    # the bfloat16 codes, written as float32: each value a bfloat16 one
    if len(pkls) != f["nident"] or len(names) != f["nident"] or z.shape != (1, 4, 4, 16) \
            or z.dtype != np.float32 or not np.isfinite(z).all() or not np.array_equal(
                z, torch.from_numpy(z).to(torch.bfloat16).float().numpy()):
        raise AssertionError(f"bf16 cli.generate_id_cond: {pkls}, z_geo {z.dtype} {z.shape}")
    if launches != (2 + 2, 0, 0):  # 2 eval items, 1 frame of 2 decodes
        raise AssertionError(f"bf16 cli: launches {launches}")
    log("bf16-cli", eval=json.dumps(result), render_pngs=len(pngs), id_conds=len(pkls),
        fwd_launches=launches[0], bwd_launches=launches[1])
    return launches


TURN_END = BF16_END + 12  # each turn: the step-10 checkpoint to step 22


def dtype_turns(dev: torch.device, work: Path) -> tuple:
    """The float32 and bfloat16 step times, comparable: cli.train resumed from
    the step-10 checkpoints of [loop-steady] (float32) and [bf16-train]
    (bfloat16) to step 22, untraced and past the warm-up, in the order fp32,
    bf16, bf16, fp32, so that a drift of the host's pace over the phase falls
    on both dtypes alike. Each call's first step is left out (first in its
    call): 11 steps a call, 22 a dtype. Checked: one launch of each kernel per
    step, finite losses."""
    sources = {"fp32": ([], work / "steady"), "bf16": (BF16_OPTS, work / "bf16")}
    order = ["fp32", "bf16", "bf16", "fp32"]
    ms = {"fp32": [], "bf16": []}
    p50 = []
    reset_march_launches()  # this path starts here
    with Watched() as watched:
        for i, arm in enumerate(order):
            extra, src = sources[arm]
            state = cli_train.main(
                ["--config", FLAGSHIP_YAML, "--device", str(dev), f"assets={work / 'assets'}",
                 f"progress.output_path={work / f'turn-{i}-{arm}'}",
                 f"train.checkpoint={src / 'checkpoints'}", f"train.warmup_iters={STEADY_WARMUP}",
                 f"train.maxiter={TURN_END}"] + extra)
            if state.step != TURN_END:
                raise AssertionError(f"dtype-turns: {arm} ended at step {state.step}")
            del state
            shutil.rmtree(work / f"turn-{i}-{arm}")  # its step-22 checkpoint
            steps = watched.ms(i)[1:]
            ms[arm] += steps
            p50.append(round(float(np.median(steps)), 3))
    launches = march_launches()  # this path ends here
    GRID_LAUNCHES["dtype_turns"] = grid_launches()
    n = 4 * (TURN_END - BF16_END)
    if launches != (n, n, n) or any(s[2] != (1, 1, 1) for s in watched.steps) or not all(
            np.isfinite(v) for v in watched.losses):
        raise AssertionError(f"dtype-turns: launches {launches}, losses {watched.losses}")
    fp32, bf16 = (round(float(np.median(ms[a])), 3) for a in ("fp32", "bf16"))
    log("dtype-turns", order=order, steptimer_p50_ms=p50, steps_per_call=len(ms["fp32"]) // 2,
        fp32_p50_ms=fp32, bf16_p50_ms=bf16, bf16_over_fp32=round(bf16 / fp32, 4),
        fwd_launches=launches[0], bwd_launches=launches[1], bwd_with_state=launches[2])
    return launches


def repeat(dev: torch.device, work: Path):
    """[repeat]: a flagship training step repeats bit for bit. For each arm,
    float32 from [loop-steady]'s step-10 checkpoint, bfloat16 from
    [bf16-train]'s and the compacted marcher (``backend: xla``) from
    [xla-train]'s step-2 checkpoint: the state restored and one normal step
    taken on one batch with the step's noise, twice, under the deterministic
    mode every path that builds the model runs in. Every loss term, gradient
    (after the scrub and clip), parameter and Adam moment and step count must
    be bitwise equal, or the phase fails; printed: how many of each are."""
    arms = (("fp32", [], work / "steady"), ("bf16", BF16_OPTS, work / "bf16"),
            ("xla", ["model.raymarch.backend=xla"], work / "xla_run"))
    counts = {}
    reset_march_launches()  # this path starts here
    for arm, opts, run in arms:
        cfg = load_config(FLAGSHIP_YAML, [f"assets={work / 'assets'}"] + opts)
        ds = loop.build_dataset(cfg)
        model = loop.build_model(cfg, ds, loop.load_uvdata(cfg), dev)
        optimizer = make_optimizer(model, cfg.train.optimizer, cfg.train.init_learning_rate,
                                   cfg.train.gamma, cfg.train.lr_scheduler_iter, cfg.train.clip)
        train_step = make_train_step(model, optimizer, dict(cfg.train.losses), ds.vertmean,
                                     ds.vertstd, output_set=frozenset(cfg.train.output_set))
        batch = Uploader(dev).now(loop.to_model_batch(none_collate(
            [ds[i] for i in range(FLAGSHIP["batch"])])))

        def one_step():
            state = restore_checkpoint(run / "checkpoints", TrainState(model, optimizer, 0))
            state, loss, terms = train_step(state, batch,
                                            generator=step_generator(dev, state.step),
                                            running_avg_scale=False, use_gt_geo=False,
                                            residuals_weight=1.0)
            kept = {("loss", "total"): loss, **{("loss", k): v for k, v in terms.items()}}
            for name, prm in model.named_parameters():
                kept[("param", name)] = prm.detach().clone()
                if prm.grad is not None:
                    kept[("grad", name)] = prm.grad.detach().clone()
                for key, val in optimizer.core.state.get(prm, {}).items():
                    kept[("adam", f"{name}.{key}")] = torch.as_tensor(val).clone()
            fixed_point.check(dev)
            return kept

        first, second = one_step(), one_step()
        if first.keys() != second.keys():
            raise AssertionError(f"repeat {arm}: the two steps kept different tensors")
        same = {}
        for key in first:
            kind = key[0]
            n, e = same.get(kind, (0, 0))
            same[kind] = (n + 1, e + int(torch.equal(first[key], second[key])))
        counts[arm] = {kind: f"{e}/{n}" for kind, (n, e) in same.items()}
        del model, optimizer, train_step, first, second
        torch.cuda.empty_cache()
        if any(e != n for n, e in same.values()):
            raise AssertionError(f"repeat {arm}: not bitwise equal: {counts[arm]}")
    launches = march_launches()  # this path ends here
    GRID_LAUNCHES["repeat"] = grid_launches()
    log("repeat", equal=json.dumps(counts), fwd_launches=launches[0], bwd_launches=launches[1])
    return launches


RESUME_EVERY, RESUME_END = 4, 8


def resume_exact(dev: torch.device, work: Path):
    """[resume-exact]: cli.train on the flagship yaml from scratch to step 8
    with a checkpoint every 4 steps (the one saved after step 4 holds 5
    steps), then a second run that finds a copy of that checkpoint in its own
    output directory, as a preempted run finds its own, and goes on to step
    8. The two step-8 checkpoints (parameters and adaptwarps, optimizer
    state, step) must be bitwise equal, and so must the losses the two runs
    log for steps 5 to 7."""
    first, second = work / "resume-a", work / "resume-b"
    argv = ["--config", FLAGSHIP_YAML, "--device", str(dev), f"assets={work / 'assets'}",
            f"train.checkpoint_every={RESUME_EVERY}", f"train.maxiter={RESUME_END}"]
    t0 = time.perf_counter()
    reset_march_launches()  # this path starts here
    with Watched() as whole:
        cli_train.main(argv + [f"progress.output_path={first}"])
    mid = max(n for c in (first / "checkpoints").glob("step_*.pt")
              if (n := int(c.stem.split("_")[1])) < RESUME_END)
    (second / "checkpoints").mkdir(parents=True)
    shutil.copy(first / "checkpoints" / f"step_{mid:08d}.pt", second / "checkpoints")
    with LogLines() as log_lines, Watched() as resumed:
        cli_train.main(argv + [f"progress.output_path={second}"])
    launches = march_launches()  # this path ends here
    GRID_LAUNCHES["resume_exact"] = grid_launches()
    if not any("Resumed from" in ln and f"step {mid}" in ln for ln in log_lines.lines):
        raise AssertionError(f"resume-exact: the second run did not resume at step {mid}")
    again = whole.losses[mid:]
    if resumed.losses != again or len(again) != RESUME_END - mid:
        raise AssertionError(f"resume-exact: losses {resumed.losses} after the resume, "
                             f"{again} in the whole run")
    ckpt = [torch.load(run / "checkpoints" / f"step_{RESUME_END:08d}.pt", map_location="cpu",
                       weights_only=True) for run in (first, second)]
    unequal = [key for key, a, b in flat_items(ckpt[0], ckpt[1]) if not equal_items(a, b)]
    if unequal:
        raise AssertionError(f"resume-exact: the step-{RESUME_END} checkpoints differ in "
                             f"{unequal[:8]} ({len(unequal)} entries)")
    log("resume-exact", steps=RESUME_END, resumed_from=mid, losses=again,
        checkpoint_entries=len(flat_items(ckpt[0], ckpt[1])), checkpoints_equal=True,
        fwd_launches=launches[0], bwd_launches=launches[1],
        seconds=round(time.perf_counter() - t0, 3))
    return launches


TRACEPROF_SHARE = 0.95  # of a traced step's device time on a source line of the package


def traceprof_phase(model, ds, batch, dev: torch.device):
    """[traceprof]: ``python -m ava256_tpu_torch.traceprof``'s traced step
    (``traceprof.trace_step``: the warm-up step, a normal one, then one
    more traced with Python stacks and the model's module scopes) on the
    flagship model of [train], and its aggregation: the device time on a
    source line must be at least TRACEPROF_SHARE of the step's. Printed: that
    share, the 10 largest source lines and modules, and the modules and lines
    behind the conv-gradient kernels (``*wgrad*``, ``*dgrad*``)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        reset_march_launches()  # this path starts here
        path = traceprof.trace_step(model, batch, ds, tmp, dev)
        launches = march_launches()  # this path ends here
        GRID_LAUNCHES["traceprof"] = grid_launches()
        traced_s = time.perf_counter() - t0
        trace_mb = path.stat().st_size / 2**20
        rep = traceprof.aggregate(path, 10, nvidia_smi(), out=io.StringIO())
    if launches != (3, 3, 3) or rep["attributed_share"] < TRACEPROF_SHARE:
        raise AssertionError(f"traceprof: launches {launches}, device time on a source line "
                             f"{rep['attributed_share']:.4f} (at least {TRACEPROF_SHARE})")
    log("traceprof", total_device_ms=round(rep.get("total_device_s", math.nan) * 1e3, 3),
        attributed_share=round(rep["attributed_share"], 5),
        top_lines=json.dumps(rep["top_lines"]), top_modules=json.dumps(rep["top_modules"]),
        conv_grad_kernels=json.dumps(rep["conv_grad_kernels"]),
        trace_mb=round(trace_mb, 1), traced_s=round(traced_s, 3),
        seconds=round(time.perf_counter() - t0, 3))
    return launches


def fwdprof_phase(dev: torch.device) -> tuple:
    """[fwdprof]: ``python -m ava256_tpu_torch.fwdprof``'s split of the
    forward march op on kbench's shell scene (cull, the template table,
    the affines, the kernel with and without the state, untile, the whole
    op); the parts composed must give the op's output bit for bit."""
    t0 = time.perf_counter()
    reset_march_launches()  # this path starts here
    rep = fwdprof.profile(dev)
    launches = march_launches()  # this path ends here
    if not rep["bitwise_equal"] or launches[0] < 1:
        raise AssertionError(f"fwdprof: composed parts equal to the op: "
                             f"{rep['bitwise_equal']}, forward launches {launches[0]}")
    log("fwdprof", **{k[:-2] + "_ms" if k.endswith("_s") else k:
                      round(v * 1e3, 4) if k.endswith("_s") else v for k, v in rep.items()},
        seconds=round(time.perf_counter() - t0, 3))
    return launches


# [long-recipe]: the reference's round-5 recipe at a small horizon
LONG = dict(steps=12, bump=8, every=4, kill=10)
ITERATION = re.compile(r"Iteration (\d+) loss = (\S+), .* lr = (\S+), time")


def long_recipe(dev: torch.device, work: Path):
    """[long-recipe]: ``python -m ava256_tpu_torch.flagship_runs`` with the
    reference's round-5 options at a small horizon (``--arms bf16-resume
    --steps 12 --kill-after 10 --checkpoint-every 4
    train.lr_scheduler_iter=8``): a bf16 run across the StepLR bump,
    SIGKILLed in step 11 and resumed from the checkpoint saved after step 8.
    Each ``cli.train`` process is this script's ``--train-child``, so the
    resumed one's steps are watched (the killed one writes nothing). Checked:
    the run's exit code, steps 9 and 10 logged again with the same losses,
    lr 2.0e-4 before the bump and 2.8e-4 from it, the resumed process at
    step 9 with one launch of each kernel a step. The flagship's UV maps come
    from the earlier phases' cache."""
    out = work / "long"
    shutil.copytree(os.environ["AVA256_CACHE_DIR"], out / "cache")
    children, start = [], flagship_runs._start

    def watched_start(cmd, log_path, env):
        child = out / f"child_{len(children)}.json"
        children.append(child)
        args = cmd[cmd.index("ava256_tpu_torch.cli.train") + 1:]
        return start([cmd[0], os.path.abspath(__file__), "--train-child", str(child), "--"]
                     + args, log_path, env)

    argv = [str(out), "--device", dev.type, "--arms", "bf16-resume",
            "--steps", str(LONG["steps"]), "--kill-after", str(LONG["kill"]),
            "--checkpoint-every", str(LONG["every"]),
            f"train.lr_scheduler_iter={LONG['bump']}"]
    t0 = time.perf_counter()
    printed = io.StringIO()
    flagship_runs._start = watched_start
    try:
        with contextlib.redirect_stdout(printed):
            rc_runs = flagship_runs.main(argv)
    finally:
        flagship_runs._start = start
    seconds = time.perf_counter() - t0
    lines = ITERATION.findall((out / "bf16-resume" / "train.log").read_text(errors="replace"))
    first, again = {}, []
    for it, loss, lr in lines:
        if it in first:
            again.append((int(it), loss == first[it][0]))
        else:
            first[it] = (loss, lr)
    resumed = json.loads(children[-1].read_text()) if children[-1].is_file() else {}
    mid = LONG["kill"] - LONG["kill"] % LONG["every"]  # the last checkpoint's step
    lrs = {lr for it, (_, lr) in first.items() if int(it) >= LONG["bump"]}
    before = {lr for it, (_, lr) in first.items() if int(it) < LONG["bump"]}
    if rc_runs != 0 or len(children) != 2 or sorted(int(i) for i in first) != list(
            range(LONG["steps"])) or [i for i, _ in again] != list(range(mid + 1, LONG["kill"] + 1)):
        raise AssertionError(f"long-recipe: rc {rc_runs}, {len(children)} processes, steps "
                             f"{sorted(first)}, again {again}:\n{printed.getvalue()}")
    if not all(same for _, same in again) or lrs != {"2.80e-04"} or before != {"2.00e-04"}:
        raise AssertionError(f"long-recipe: re-logged {again}, lr {before} then {lrs}")
    if resumed.get("resumed_at") != [mid + 1] or resumed.get("step") != LONG["steps"] or \
            resumed["step_launches"] != [[1, 1, 1]] * (LONG["steps"] - mid - 1) or \
            not all(np.isfinite(v) for v in resumed["losses"]):
        raise AssertionError(f"long-recipe: the resumed process {resumed}")
    GRID_LAUNCHES["long_recipe"] = tuple(resumed["grid_launches"])
    log("long-recipe", steps=LONG["steps"], lr_bump_at=LONG["bump"], killed_in=LONG["kill"] + 1,
        resumed_at=mid + 1, relogged=len(again), exact=sum(same for _, same in again),
        lr_after_bump=sorted(lrs)[0], losses_resumed=resumed["losses"],
        fwd_launches=resumed["launches"][0], bwd_launches=resumed["launches"][1],
        printed=printed.getvalue().strip().splitlines(), seconds=round(seconds, 3))
    return tuple(resumed["launches"])


# [latent]: the expression latent over the first 60 steps
LATENT_STEPS, LATENT_AT, LATENT_WINDOW = 61, (18, 30, 45, 60), (40, 60)
KLDIV = re.compile(r"Iteration (\d+) loss = .*kldiv = ([^,\s]+)")


def latent(dev: torch.device, work: Path):
    """[latent]: ``cli.train`` of the flagship in bfloat16 from scratch for
    steps 0-60 (the warm-up's first 61 steps), the bottleneck's mu watched in
    every training forward. Prints the KL term (the run's log lines) and the
    largest |mu| at steps 18, 30, 45 and 60, and the median KL of steps
    40-60: the window where the flagship's latent collapses on the card (at
    this render size the inputs' doing, not the port's: ``docs/port_r12/``).
    Checked: every loss finite, one launch of each kernel a step."""
    run_dir = work / "latent"
    argv = ["--config", FLAGSHIP_YAML, "--device", str(dev), f"assets={work / 'assets'}",
            f"progress.output_path={run_dir}", f"train.maxiter={LATENT_STEPS}",
            "train.checkpoint_every=0", "progress.cross_id=false"] + BF16_OPTS
    mu_max, build = [], loop.build_model

    def watched_build(*args, **kwargs):
        model = build(*args, **kwargs)
        model.bottleneck.register_forward_hook(
            lambda m, i, out: mu_max.append(out[1].detach().abs().amax())
            if torch.is_grad_enabled() else None)
        return model

    reset_march_launches()  # this path starts here
    t0 = time.perf_counter()
    loop.build_model = watched_build
    try:
        with LogLines() as log_lines, Watched() as watched:
            state = cli_train.main(argv)
    finally:
        loop.build_model = build
    launches = march_launches()
    seconds = time.perf_counter() - t0  # this path ends here
    GRID_LAUNCHES["latent"] = grid_launches()
    kl = {int(i): float(v) for ln in log_lines.lines if (m := KLDIV.match(ln))
          for i, v in [m.groups()]}
    mu_max = [float(x) for x in mu_max]
    if state.step != LATENT_STEPS or sorted(kl) != list(range(LATENT_STEPS)) or \
            len(mu_max) != LATENT_STEPS or any(s[2] != (1, 1, 1) for s in watched.steps) or \
            launches[1] != LATENT_STEPS or not all(np.isfinite(watched.losses)):
        raise AssertionError(f"latent: step {state.step}, {len(kl)} KL lines, {len(mu_max)} "
                             f"forwards, launches {launches}, losses {watched.losses}")
    log("latent", steps=LATENT_STEPS, kldiv={i: kl[i] for i in LATENT_AT},
        mu_max_abs={i: round(mu_max[i], 4) for i in LATENT_AT},
        kldiv_window=LATENT_WINDOW,
        kldiv_median=float(np.median([kl[i] for i in range(LATENT_WINDOW[0],
                                                            LATENT_WINDOW[1] + 1)])),
        kldiv_max=max(kl.values()), kldiv_argmax=max(kl, key=kl.get),
        fwd_launches=launches[0], bwd_launches=launches[1], seconds=round(seconds, 3))
    return launches


def flat_items(a, b, key=()):
    """The (key, a's value, b's value) leaves of two nested checkpoints;
    a key only one of them has pairs with None."""
    if isinstance(a, dict) and isinstance(b, dict):
        return [item for k in sorted(set(a) | set(b), key=str)
                for item in flat_items(a.get(k), b.get(k), key + (k,))]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)) and len(a) == len(b):
        return [item for i, (x, y) in enumerate(zip(a, b)) for item in flat_items(x, y, key + (i,))]
    return [(key, a, b)]


def equal_items(a, b) -> bool:
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return type(a) is type(b) and a == b


# ---------------------------------------------------------------------------
# phase 6d: the capture-data path on configs/config-4.yaml
# ---------------------------------------------------------------------------

CONFIG4_YAML = "configs/config-4.yaml"
# what [capture-write] writes: identities, cameras and frames of the synthetic
# dataset (at the flagship's 512x334 and 1024^2 textures), the camera images'
# size and the downsample that gives the renders' rays back (config-4's)
CAPTURE = dict(nident=4, ncams=4, nframes=3, image_hw=(4096, 2668), downsample=8)
CAPTURE_FIRST_END, CAPTURE_TRACED, CAPTURE_END = 2, 5, 8


def trace_march_ms(path) -> dict:
    """Summed ms of the two march kernels in a torch.profiler trace."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "kernel"]
    return {name: round(sum(e["dur"] for e in events if name in e["name"]) / 1e3, 3)
            for name in ("mvp_march_fwd_kernel", "mvp_march_bwd_kernel")}


def capture_write(work: Path) -> Path:
    """[capture-write]: the captures in the release's layout; returns the CSV."""
    f, c = FLAGSHIP, CAPTURE
    t0 = time.perf_counter()
    syn = SyntheticDataset(nident=c["nident"], ncams=c["ncams"], nframes=c["nframes"],
                           height=f["height"], width=f["width"], texsize=f["texsize"])
    csv = write_capture(work / "captures", syn, downsample=c["downsample"],
                        image_hw=c["image_hw"])
    seconds = time.perf_counter() - t0
    files = [q for q in (work / "captures").rglob("*") if q.is_file()]
    caps, dirs = train_csv_loader(work / "captures", csv, c["nident"])
    d = Path(dirs[0])
    cam = json.loads((d / "camera_calibration.json").read_text())["KRT"][0]["cameraId"]
    with zipfile.ZipFile(d / "image" / f"cam{cam}.zip") as z:
        img = decode_png(_zip_read(z, f"cam{cam}/000001"))
    with zipfile.ZipFile(d / "uv_image" / "color.zip") as z:
        tex = decode_png(_zip_read(z, "color/000001"))
    with zipfile.ZipFile(d / "kinematic_tracking" / "registration_vertices.zip") as z:
        verts = parse_ply_vertices(z.read("000001.ply"))
    if (img.shape[:2] != tuple(c["image_hw"]) or tex.shape[:2] != (f["texsize"],) * 2
            or verts.shape != (syn.nverts, 3) or len(caps) != c["nident"]):
        raise AssertionError(f"capture-write: image {img.shape}, texture {tex.shape}, "
                             f"vertices {verts.shape}, {len(caps)} captures")
    log("capture-write", captures=len(caps), cameras=c["ncams"], frames=c["nframes"],
        image_hw=list(img.shape), texture_hw=list(tex.shape), vertices=verts.shape[0],
        files=len(files), bytes=sum(q.stat().st_size for q in files), seconds=round(seconds, 3))
    return csv


DEMOS = ("walkthrough", "keypoints", "mesh", "segmentation")


def write_demo_extras(d: Path, frames: int) -> None:
    """The two archives the demos read and ``write_capture`` does not write:
    ``keypoints_3d.zip`` (every 40th registration vertex of each frame, as
    ``.npy``) and ``segmentation_parts.zip`` (a 512x334 grey label map of
    20 labels per frame)."""
    (d / "keypoints_3d").mkdir(exist_ok=True)
    (d / "segmentation_parts").mkdir(exist_ok=True)
    rows, cols = np.mgrid[:512, :334]
    with zipfile.ZipFile(d / "kinematic_tracking" / "registration_vertices.zip") as ply, \
            zipfile.ZipFile(d / "keypoints_3d" / "keypoints_3d.zip", "w") as kp, \
            zipfile.ZipFile(d / "segmentation_parts" / "segmentation_parts.zip", "w") as seg:
        for f in range(1, frames + 1):
            buf = io.BytesIO()
            np.save(buf, parse_ply_vertices(ply.read(f"{f:06d}.ply"))[::40])
            kp.writestr(f"keypoints_3d/{f:06d}.npy", buf.getvalue())
            labels = ((rows // 32 + cols // 32 + f) % 20).astype(np.uint8)
            seg.writestr(f"segmentation_parts/{f:06d}.png", png_bytes(labels))


def demos_phase(work: Path, csv: Path):
    """[demos]: the four capture demos on the first written capture, each as
    ``python -m`` in a child process, the four side by side (each spends
    most of its time importing); any failure fails the run."""
    _, dirs = train_csv_loader(work / "captures", csv, CAPTURE["nident"])
    d = Path(dirs[0]).resolve()
    write_demo_extras(d, CAPTURE["nframes"])
    out = (work / "demos").resolve()
    out.mkdir()

    def run(name):
        png = out / f"{name}.png"
        cmd = [sys.executable, "-m", f"ava256_tpu_torch.demos.{name}", "--capture-dir", str(d),
               "--output", str(png)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        return png, cmd, res, time.perf_counter() - t0

    t_all = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(DEMOS)) as pool:
        runs = list(pool.map(run, DEMOS))
    seconds_all = time.perf_counter() - t_all
    for name, (png, cmd, res, seconds) in zip(DEMOS, runs):
        if res.returncode != 0 or f"wrote {png}" not in res.stdout:
            raise AssertionError(f"demos: {' '.join(cmd)} exited {res.returncode}:\n"
                                 f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        h, w, _ = png_size(png)
        log("demos", demo=name, seconds=round(seconds, 3), png_hw=[h, w],
            panels=[ln for ln in res.stdout.splitlines() if ln.startswith("panel ")][:4])
    log("demos-done", seconds=round(seconds_all, 3))


def capture_io(work: Path, csv: Path):
    """[capture-io]: one item's fetch on this host, part by part, and the
    host library's resize against its numpy restatement at full size."""
    c = CAPTURE
    caps, dirs = train_csv_loader(work / "captures", csv, c["nident"])
    ds = MultiCaptureDataset(caps, dirs, downsample=c["downsample"])
    single = ds.single_capture_datasets[caps[0]]
    _, frame, cam = single.item_ids(0)
    t = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        t[name] = round((time.perf_counter() - t0) * 1e3, 3)
        return out

    data = timed("zip_read_ms", lambda: _zip_read(single._zip(f"image/cam{cam}.zip"),
                                                  f"cam{cam}/{int(frame):06d}"))
    img = timed("decode_png_ms", lambda: decode_png(data))
    ply = single._zip("kinematic_tracking/registration_vertices.zip").read(f"{int(frame):06d}.ply")
    timed("ply_ms", lambda: parse_ply_vertices(ply))
    h, w = ds.get_img_size()
    small = timed("resize_ms", lambda: native.resize_bilinear_u8(img, (h, w)))
    plain = timed("resize_plain_ms", lambda: native.resize_bilinear_u8_plain(img, (h, w)))
    off = np.abs(small.astype(np.int16) - plain)
    if small.shape != (h, w, 3) or int(off.max()) > 1:
        raise AssertionError(f"capture-io: resize {small.shape}, max |d| {int(off.max())} "
                             "levels from its plain version (limit 1)")
    fetch_ms = []
    for i in range(4):
        t0 = time.perf_counter()
        item = ds[i]
        fetch_ms.append(round((time.perf_counter() - t0) * 1e3, 3))
        if item is None or item["image"].shape != (h, w, 3):
            raise AssertionError(f"capture-io: item {i} is {item and item['image'].shape}")
    log("capture-io", image_hw=list(img.shape), img_size=[h, w], fetch_ms=fetch_ms,
        resize_levels_off_by_1=int((off == 1).sum()), resize_max_levels_off=int(off.max()),
        **t)
    return (h, w)


def loaderbench_phase():
    """[loaderbench]: ``python -m ava256_tpu_torch.loaderbench --frames 12
    --items 24`` in a child process on this host (one capture of 2 cameras x
    12 frames at 4096x2668, ShardedLoader items/s with 1, 2 and 4 threads),
    its JSON line printed under the tag."""
    t0 = time.perf_counter()
    line, = child_json([sys.executable, "-m", "ava256_tpu_torch.loaderbench", "--frames", "12",
                        "--items", "24"], "loaderbench")
    if not all(line[f"items_per_s_w{n}"] > 0 for n in (1, 2, 4)):
        raise AssertionError(f"loaderbench: {line}")
    print(f"[loaderbench] {json.dumps(line)}", flush=True)
    log("loaderbench-run", seconds=round(time.perf_counter() - t0, 3))


def capture_train(dev: torch.device, work: Path, csv: Path, img_hw, flagship_steady: dict):
    """[capture-train]: cli.train on config-4 over the written captures, 2
    steps from scratch, then a resume to step 8 with step 5 traced."""
    run_dir = work / "capture_run"
    argv = ["--config", CONFIG4_YAML, "--device", str(dev),
            f"train.dataset_dir={work / 'captures'}", f"train.data_csv={csv}",
            f"assets={work / 'assets'}", f"progress.output_path={run_dir}"]
    ckpt_dir = run_dir / "checkpoints"
    torch.cuda.reset_peak_memory_stats(dev)
    reset_march_launches()  # this path starts here
    t0 = time.perf_counter()
    with LogLines() as log_lines, Watched(cached=("neut_avgtex", "neut_verts")) as watched:
        state = cli_train.main(argv + [f"train.maxiter={CAPTURE_FIRST_END}"])
        if state.step != CAPTURE_FIRST_END or latest_checkpoint_step(ckpt_dir) != CAPTURE_FIRST_END:
            raise AssertionError(f"capture-train: step {state.step} after the first call")
        kept = [p.detach().clone() for p in state.model.parameters()]
        del state
        state = cli_train.main(argv + [f"train.maxiter={CAPTURE_END}",
                                       f"progress.profile_at={CAPTURE_TRACED}"])
    launches = march_launches()
    seconds = time.perf_counter() - t0  # this path ends here
    GRID_LAUNCHES["capture_train"] = grid_launches()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    lines, steps = log_lines.lines, watched.steps
    if state.step != CAPTURE_END or len(steps) != CAPTURE_END:
        raise AssertionError(f"capture-train: step {state.step}, {len(steps)} steps")
    if any(s[2] != (1, 1, 1) for s in steps):
        raise AssertionError(f"capture-train: launches per step {[s[2] for s in steps]}")
    bsz = int(load_config(CONFIG4_YAML).train.batchsize)
    if any(len(s[0]) != bsz for s in steps) or any("failed to fetch" in ln for ln in lines):
        raise AssertionError("capture-train: a batch lost an item: "
                             f"{[len(s[0]) for s in steps]}")
    if not any("Resumed from" in ln and f"step {CAPTURE_FIRST_END}" in ln for ln in lines):
        raise AssertionError("capture-train: the second call did not resume")
    its = [(float(m.group(1)), float(m.group(2))) for ln in lines
           if (m := re.match(r"Iteration \d+ loss = (\S+),.* time: (\S+) s", ln))]
    losses = [v for v, _ in its]
    if len(losses) != CAPTURE_END or not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"capture-train: losses {losses}")
    params = list(state.model.parameters())
    if all(torch.equal(p.detach(), q) for p, q in zip(params, kept)):
        raise AssertionError("capture-train: the resumed steps changed no parameter")
    h, w = img_hw
    if png_size(run_dir / "progress_0.png") != (bsz * h, 3 * w, 3):
        raise AssertionError(f"capture-train: progress_0.png is "
                             f"{png_size(run_dir / 'progress_0.png')}")
    xid = png_size(run_dir / "x-id" / "progress_0.png")
    if xid[0] != h or xid[1] % w or xid[2] != 3:
        raise AssertionError(f"capture-train: x-id/progress_0.png is {xid}")
    ms = dict(zip(range(CAPTURE_END), watched.ms(0) + watched.ms(1)))
    steady = [ms[i] for i in range(CAPTURE_END)
              if i not in (0, CAPTURE_FIRST_END, CAPTURE_TRACED)]
    p50 = float(np.median(steady))
    trace = run_dir / "profile" / TRACE_FILE
    log("capture-train", steps=CAPTURE_END, resumed_at=CAPTURE_FIRST_END, traced=CAPTURE_TRACED,
        losses=[round(v, 4) for v in losses], steptimer_ms=ms,
        iteration_s=[round(t, 3) for _, t in its],
        steptimer_p50_ms_steady=round(p50, 3), steady_steps=len(steady),
        march_ms_traced=trace_march_ms(trace),
        peak_gib=round(peak_gib, 3), fwd_launches=launches[0], bwd_launches=launches[1],
        bwd_with_state=launches[2], seconds=round(seconds, 3),
        flagship_steady=json.dumps(flagship_steady))
    return launches


def capture_cli(dev: torch.device, work: Path, csv: Path, img_hw):
    """[capture-cli]: cli.eval on the last camera, cli.render and
    cli.generate_id_cond on the capture run's checkpoint."""
    common = ["--config", CONFIG4_YAML, "--device", str(dev),
              "--checkpoint", str(work / "capture_run" / "checkpoints")]
    opts = ["--opts", f"train.dataset_dir={work / 'captures'}", f"train.data_csv={csv}",
            f"assets={work / 'assets'}"]
    reset_march_launches()  # this path starts here
    t0 = time.perf_counter()
    result = cli_eval.main(common + ["--holdout-cameras", "1", "--num-items", "2"] + opts)
    rendered = cli_render.main(common + ["--num-frames", "1", "--output",
                                         str(work / "capture_renders")] + opts)
    names = cli_idc.main(common + ["--output", str(work / "capture_id_conds")] + opts)
    launches = march_launches()
    seconds = time.perf_counter() - t0  # this path ends here
    GRID_LAUNCHES["capture_cli"] = grid_launches()
    if result["split"] != "heldout_cameras" or result["items"] != 2 or not all(
            np.isfinite(result[k]) for k in ("psnr_db", "ssim", "lpips_rf")):
        raise AssertionError(f"capture-cli: eval {result}")
    h, w = img_hw
    pngs = sorted((work / "capture_renders").glob("render_*.png"))
    if rendered != 1 or len(pngs) != 1 or png_size(pngs[0]) != (h, 3 * w, 3):
        raise AssertionError(f"capture-cli: render {rendered}, {pngs}")
    pkls = sorted(q.name for q in (work / "capture_id_conds").glob("*.pkl"))
    if len(names) != CAPTURE["nident"] or pkls != sorted(n + ".pkl" for n in names):
        raise AssertionError(f"capture-cli: id conds {pkls} for {names}")
    if launches != (2 + 2, 0, 0):  # 2 eval items, 1 frame of 2 decodes
        raise AssertionError(f"capture-cli: kernel launches {launches}")
    log("capture-cli", eval=json.dumps(result), render_pngs=len(pngs), id_conds=pkls,
        fwd_launches=launches[0], bwd_launches=launches[1], seconds=round(seconds, 3))
    return launches


# ---------------------------------------------------------------------------
# phase 6e: data-parallel training on the 262,144-primitive configuration
# ---------------------------------------------------------------------------

CONFIG262K_YAML = "configs/config-synthetic-262k.yaml"
DDP_FIRST_END, DDP_END = 2, 3  # the launched run: 2 steps, then a resume to 3
# Every loss of the launched run must equal the single process's exactly: the
# same seed, batches and noise, a training step that repeats bit for bit, a
# mean over one rank that is exact, and a resume that restores every bit.
GROUP_LINE = re.compile(r"Process group: backend (\S+), rank (\d+) of (\d+), on (\S+)")


def train_child(out: Path, argv: list) -> int:
    """A process that ``[ddp-train]`` (under the launcher) and
    ``[long-recipe]`` (through ``flagship_runs``) start: ``cli.train``
    (``cli.train.main(argv)``, what ``-m ava256_tpu_torch.cli.train`` runs)
    with its steps watched, the result written to ``out`` as JSON when it
    ends."""
    reset_march_launches()  # this path starts here
    with LogLines() as log_lines, Watched() as watched:
        state = cli_train.main(argv)
    launches = march_launches()  # this path ends here
    GRID_LAUNCHES["child"] = grid_launches()
    device = next(state.model.parameters()).device
    out.write_text(json.dumps(dict(
        step=state.step, losses=watched.losses, steptimer_ms=watched.ms(0),
        step_launches=[s[2] for s in watched.steps], launches=launches,
        groups=[m.groups() for ln in log_lines.lines if (m := GROUP_LINE.match(ln))],
        resumed_at=[int(m.group(1)) for ln in log_lines.lines
                    if (m := re.match(r"Resumed from .* at step (\d+)", ln))],
        collectives=dict(parallel.COUNTS), group_left=not parallel.is_initialized(),
        grid_launches=GRID_LAUNCHES["child"],
        device=str(device), peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)))
    return 0


def ddp_train(dev: torch.device, work: Path):
    """[ddp-train]: cli.train on the 262k configuration at full width, one
    process for 3 steps, then under the launcher (one process, NCCL) for 2
    steps and a resume to 3; the launched run's losses against the single
    process's. Returns (launches, the single run's state, the phase's numbers)."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_march_launches()  # the single process's path starts here
    with Watched() as watched:
        state = cli_train.main(["--config", CONFIG262K_YAML, "--device", str(dev),
                                f"assets={work / 'assets'}", f"train.maxiter={DDP_END}",
                                f"progress.output_path={work / 'run262k'}"])
    launches = march_launches()  # and ends here
    GRID_LAUNCHES["ddp_train"] = grid_launches()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    single_s = time.perf_counter() - t0
    if state.step != DDP_END or [s[2] for s in watched.steps] != [(1, 1, 1)] * DDP_END:
        raise AssertionError(f"ddp-train: single process at step {state.step}, launches "
                             f"{[s[2] for s in watched.steps]}")
    runs = []
    for end in (DDP_FIRST_END, DDP_END):
        out = work / f"ddp_{end}.json"
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
               "1", os.path.abspath(__file__), "--train-child", str(out), "--", "--config",
               CONFIG262K_YAML, "--device", dev.type, f"assets={work / 'assets'}",
               f"train.maxiter={end}", "mesh.multihost=true",
               f"progress.output_path={work / 'run262k_ddp'}"]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0 or not out.is_file():
            raise AssertionError(f"ddp-train: the launched run to step {end} exited "
                                 f"{res.returncode}:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        runs.append(json.loads(out.read_text()))
    seconds = time.perf_counter() - t0
    first, resumed = runs
    group = ["nccl" if dev.type == "cuda" else "gloo", "0", "1", str(dev)]
    for run, steps in ((first, DDP_FIRST_END), (resumed, DDP_END - DDP_FIRST_END)):
        if run["groups"] != [group] or not run["group_left"]:
            raise AssertionError(f"ddp-train: process group {run['groups']}, left "
                                 f"{run['group_left']}")
        if run["collectives"]["all_reduce_gradients"] < steps or \
                run["step_launches"] != [[1, 1, 1]] * steps:
            raise AssertionError(f"ddp-train: {run['collectives']} and launches "
                                 f"{run['step_launches']} in {steps} steps")
    if (first["step"], resumed["step"], resumed["resumed_at"]) != (DDP_FIRST_END, DDP_END,
                                                                    [DDP_FIRST_END]):
        raise AssertionError(f"ddp-train: steps {first['step']}, {resumed['step']}, resumed at "
                             f"{resumed['resumed_at']}")
    single, launched = watched.losses, first["losses"] + resumed["losses"]
    if not all(np.isfinite(v) for v in single + launched):
        raise AssertionError(f"ddp-train: losses {single} / {launched}")
    if launched != single:
        raise AssertionError(f"ddp-train: the launched run's losses {launched!r} are not the "
                             f"single process's {single!r}")
    ms = watched.ms(0)
    steady = ms[1:] + first["steptimer_ms"][1:]  # not the first step of a call
    log("ddp-train", config=CONFIG262K_YAML, backend=group[0], world=1, steps_single=DDP_END,
        steps_launched=f"{DDP_FIRST_END}+{DDP_END - DDP_FIRST_END}",
        losses_single=single, losses_launched=launched, losses_equal=True,
        grad_allreduces=[first["collectives"]["all_reduce_gradients"],
                         resumed["collectives"]["all_reduce_gradients"]],
        steptimer_ms_single=ms, steptimer_ms_launched=first["steptimer_ms"],
        steptimer_ms_resumed=resumed["steptimer_ms"],
        steptimer_p50_ms_steady=round(float(np.median(steady)), 3), steady_steps=len(steady),
        peak_gib_single=round(peak_gib, 3),
        peak_gib_launched=[round(first["peak_gib"], 3), round(resumed["peak_gib"], 3)],
        fwd_launches=launches[0] + first["launches"][0] + resumed["launches"][0],
        bwd_launches=launches[1] + first["launches"][1] + resumed["launches"][1],
        single_process_s=round(single_s, 3), seconds=round(seconds, 3))
    GRID_LAUNCHES["ddp_train"] = tuple(
        a + b + c for a, b, c in zip(GRID_LAUNCHES["ddp_train"], first["grid_launches"],
                                     resumed["grid_launches"]))
    total = tuple(a + b + c for a, b, c in zip(launches, first["launches"], resumed["launches"]))
    return total, state


def kernel_262k(model, dev: torch.device):
    """[262k-kernel]: both kernels against their plain versions on the 262k
    configuration's scene (a batch of its dataset rendered by the model
    [ddp-train] trained: 262,144 primitives of 2^3, culled in two stages)."""
    cfg = load_config(CONFIG262K_YAML)
    ds = loop.build_dataset(cfg)
    bsz = int(cfg.train.batchsize)
    b = Uploader(dev).now(loop.to_model_batch(none_collate([ds[i] for i in range(bsz)])))
    model.eval()
    with torch.inference_mode():
        mi = model(target_neut_avgtex=b["neut_avgtex"], target_neut_verts=b["neut_verts"],
                   idindex=b["idindex"], camindex=b["camindex"], deterministic=True,
                   output_set=frozenset({"march_inputs"}),
                   **{k: b[k] for k in BATCH_MODEL_KEYS})["march_inputs"]
    n, K = mi["primpos"].shape[:2]
    if (K, mi["template"].shape[2]) != (cfg.model.nprims, cfg.model.primsize):
        raise AssertionError(f"262k-kernel: scene of {K} primitives of {mi['template'].shape}")
    rm = cfg.model.raymarch
    args, state, plain_state, boxes, samples, k = flagship_kernel(
        mi, dev, "262k-kernel", tile=rm.tile, max_hit=rm.max_hit)
    kb = flagship_kernel_bwd(args, state, plain_state, boxes, samples, dev, "262k-kernel-bwd")
    return k, kb


# ---------------------------------------------------------------------------
# phases 7 and 8: the kernels vs plain on the flagship scene
# ---------------------------------------------------------------------------


def flagship_scene_args(mi, dev: torch.device, tile: int, max_hit: int):
    """The march kernels' arguments on a scene: a render's decoder output and
    rays, culled as the op culls them (in two stages at K >= 65,536).
    Returns (args of ``rc.march_tiles``, gid [NT, MH] int64, valid [NT, MH])."""
    dt = float(mi["stepsize"])
    nbuf = rc.default_nbuf(dt)
    n, K = mi["primpos"].shape[:2]
    bs = mi["template"].shape[2]
    with torch.inference_mode():
        tmm = mi["tminmax"]
        tmm = torch.stack([tmm[..., 0], torch.minimum(tmm[..., 1], tmm[..., 0] + nbuf * dt)], -1)
        pm = torch.ones((n, K), device=dev)
        t_o, t_d, t_mm, gid, valid, _, _ = rc.tile_and_cull(
            mi["raypos"], mi["raydir"], tmm, mi["primpos"], mi["primscale"], pm, tile, max_hit,
            dt)
        scal = rc.candidate_affines(mi["primpos"], mi["primrot"], mi["primscale"], gid, valid)
        args = (gid.to(torch.int32).contiguous(), scal, t_o, t_d, t_mm,
                mi["template"].reshape(n * K, bs, bs, bs, 4).contiguous(), None, dt, 8.0, 8.0,
                nbuf)
    return args, gid, valid


def flagship_kernel(mi, dev: torch.device, phase: str = "flagship-kernel",
                    tile: int = FLAGSHIP["tile"], max_hit: int = FLAGSHIP["max_hit"]):
    """The forward kernel against its plain version on every tile of a scene
    (the flagship render's by default), timed."""
    dt = float(mi["stepsize"])
    args, gid, valid = flagship_scene_args(mi, dev, tile, max_hit)
    t_o, nbuf, bs = args[2], args[10], args[5].shape[1]
    with torch.inference_mode():
        march_ms = cuda_ms(lambda: rc.mvp_raymarch_cuda(
            mi["raypos"], mi["raydir"], dt, mi["tminmax"], mi["primpos"], mi["primrot"],
            mi["primscale"], mi["template"], tile=tile, max_hit=max_hit, device=dev), reps=3)
        kern, state = rc.march_tiles_kernel(*args, with_state=True)
        kernel_ms = cuda_ms(lambda: rc.march_tiles_kernel(*args), reps=5)
        state_ms = cuda_ms(lambda: rc.march_tiles_kernel(*args, with_state=True), reps=5)
        counts = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain, plain_state = rc.march_tiles_plain(*args, counts=counts, with_state=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(rc.march_tiles_kernel(*args), kern):
            raise AssertionError("flagship scene: the output changes with the state output")
    err = check_close(f"{phase} scene", kern, plain)
    state_err = check_close(f"{phase} scene, saturation state", state, plain_state)
    saturated = float((plain_state[:, 3] > 0).float().mean())

    ntiles, mh = gid.shape
    t2 = t_o.shape[2]
    boxes = int(torch.unique(gid[valid]).numel())
    samples = int(counts["samples"])
    nbytes = (boxes * bs**3 * 4 * 4 + ntiles * mh * (4 + 12 * 4) + ntiles * t2 * 8 * 4
              + ntiles * 4 * t2 * 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = samples * OPS_PER_SAMPLE / FP32_OPS_PER_S * 1e3
    no_reuse_ms = ntiles * mh * bs**3 * 16 / HBM_BYTES_PER_S * 1e3
    log(phase, tiles=ntiles, max_hit=mh, nbuf=nbuf, valid_candidates=int(valid.sum()),
        boxes=boxes, samples=samples, bytes=nbytes, max_abs_err=err,
        state_max_abs_err=state_err, saturated_rays=round(saturated, 4),
        kernel_ms=round(kernel_ms, 4), kernel_with_state_ms=round(state_ms, 4),
        plain_ms=round(plain_ms, 3),
        raymarch_op_ms=round(march_ms, 4), bound_bytes_ms=round(bytes_ms, 5),
        bound_ops_ms=round(ops_ms, 5), per_tile_box_bytes_ms=round(no_reuse_ms, 5))
    return args, state, plain_state, boxes, samples, dict(
        max_abs_err=max(err, state_err), ms=kernel_ms, ms_with_state=state_ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def flagship_kernel_bwd(args, state, plain_state, boxes: int, samples: int, dev: torch.device,
                        phase: str = "flagship-kernel-bwd"):
    """args: the forward kernel's arguments on a scene; state: its
    second output there, which only the backward kernel is given; plain_state:
    the plain forward's, which only the plain backward is given, so that the
    reference starts from nothing a kernel produced; samples: the (ray, row,
    candidate) samples the plain forward counted there."""
    gid, scal, t_o, t_d, t_mm, tpl, warp, dt, fadescale, fadeexp, nbuf = args
    ntiles, mh = gid.shape
    t2 = t_o.shape[2]
    bs = tpl.shape[1]
    g = torch.randn((ntiles, 4, t2), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))

    every = (gid, scal, t_o, t_d, t_mm, g)
    sel = slice(0, ntiles, BWD_PLAIN_STRIDE)
    some = tuple(x[sel].contiguous() for x in every)
    some_state = state[sel].contiguous()
    some_plain_state = plain_state[sel].contiguous()

    def kernel(tiles=every, st=state, counts=None):
        return rc.march_tiles_bwd_kernel(*tiles, tpl, warp, dt, fadescale, fadeexp, nbuf,
                                         counts=counts, state=st)

    counts = {}
    with torch.inference_mode():
        run1 = kernel(counts=counts)
        run2 = kernel()
        rerun = max(float((a - b).abs().max() / a.abs().max())
                    for a, b in zip(run1, run2) if a is not None)
        for name, x in zip(("d_template", "d_warp", "d_affine"), run1):
            if x is not None and not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{phase}: non-finite {name}")
        if rerun != 0.0 or not all(torch.equal(a, b) for a, b in zip(run1, run2)
                                   if a is not None):
            raise AssertionError(f"{phase}: two runs differ (max rel {rerun})")
        del run2
        # bits of headroom of each template channel's fixed-point bound (over
        # the cells the forward read, as the kernel takes it) over its largest
        # gradient (the kernel's header says what they cost)
        bounds, _ = rc.fixed_point_bounds(g, scal, tpl, warp, dt, fadescale, fadeexp, nbuf,
                                          state=state)
        headroom = [round(math.log2(float(b) / float(run1[0][..., c].abs().max())), 2)
                    for c, b in enumerate(bounds[:4].tolist())]
        fixed_point.check(dev)
        kernel_ms = cuda_ms(kernel, reps=5)
        no_state = kernel(st=None)  # the wrapper runs the forward kernel for the state
        no_state_diff = max(float((a - b).abs().max() / a.abs().max())
                            for a, b in zip(run1, no_state) if a is not None)
        del no_state
        no_state_ms = cuda_ms(lambda: kernel(st=None), reps=5)
        sub = kernel(some, some_state)
        sub_ms = cuda_ms(lambda: kernel(some, some_state), reps=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with plain_check():
            plain = rc.march_tiles_bwd_plain(*some, tpl, warp, dt, fadescale, fadeexp, nbuf,
                                             state=some_plain_state)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    errs = {name: check_grad(f"{phase} {name}", a, b)
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
    log(phase, tiles=ntiles, samples=samples, marched_samples=fwd_samples,
        chained_samples=chained, bytes=nbytes, kernel_ms=round(kernel_ms, 4),
        kernel_without_state_ms=round(no_state_ms, 4), rerun_max_rel_diff=rerun,
        headroom_bits=headroom,
        without_state_max_rel_diff=no_state_diff, plain_tiles=nsub,
        plain_tiles_of=f"every {BWD_PLAIN_STRIDE}th tile",
        kernel_ms_on_those_tiles=round(sub_ms, 4), plain_ms_on_those_tiles=round(plain_ms, 3),
        bound_bytes_ms=round(bytes_ms, 5), bound_ops_ms=round(ops_ms, 5),
        two_march_ops_ms=round(design_ops_ms, 5),
        **{f"max_rel_err_{k}": v for k, v in errs.items()})
    return dict(max_abs_err=max(errs.values()), ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                tiles=ntiles, plain_tiles=nsub, ms_on_plain_tiles=sub_ms,
                ms_without_state=no_state_ms, two_march_ops_ms=design_ops_ms)


# ---------------------------------------------------------------------------
# phase 8b: the grid-sample kernel
# ---------------------------------------------------------------------------

GRID_SITES = ("models.encoders.identity", "models.decoders.geometry")


def record_grid_samples(model, batch, dev: torch.device) -> list:
    """The (site, img, grid) of every grid_sample_2d call of one training
    forward of ``model`` on ``batch``: the identity encoder's warp of each
    level of both bias pyramids and the geometry decoder's vertex sampling,
    at the model's real shapes, values and layouts (the image kept by a
    clone in its memory format, channels-last where the convolutions ran
    channels-last; the grid as it comes, expanded over the batch)."""
    import importlib

    calls, saved = [], {}

    def recorder(site, fn):
        def rec(img, grid, align_corners=False):
            dtype = torch.promote_types(img.dtype, grid.dtype)
            calls.append((site, img.detach().to(dtype).clone(), grid.detach().to(dtype),
                          align_corners))
            return fn(img, grid, align_corners)
        return rec

    mods = {site: importlib.import_module(f"ava256_tpu_torch.{site}") for site in GRID_SITES}
    try:
        for site, mod in mods.items():
            saved[site] = mod.grid_sample_2d
            mod.grid_sample_2d = recorder(site.split(".")[-1], saved[site])
        with torch.no_grad():
            model(target_neut_avgtex=batch["neut_avgtex"], target_neut_verts=batch["neut_verts"],
                  idindex=batch["idindex"], camindex=batch["camindex"], deterministic=True,
                  output_set=frozenset({"irgbrec"}), **{k: batch[k] for k in BATCH_MODEL_KEYS})
    finally:
        for site, mod in mods.items():
            mod.grid_sample_2d = saved[site]
    return calls


def plain_grid_sample(img, grid, align, gout):
    """F.grid_sample and its own backward (PyTorch's float atomics: outside
    the deterministic mode, for this check only)."""
    out = gs.grid_sample_plain(img, grid, align)
    return (out,) + gs.grid_sample_bwd_plain(img, grid, gout, align)


GS_KERNELS = ("fwd_pixels", "fwd_packed4", "bwd_prep", "bwd_owner", "bwd_scatter",
              "zero_table", "to_float<1>")  # csrc/grid_sample.cu's kernels, by name


def profiled_kernel_ms(fn, names) -> float:
    """Device ms of the kernels named ``names`` in one fn() under
    torch.profiler (the host does not pace it, as it does CUDA events around
    a loop of small calls)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        events = json.loads(Path(f"{tmp}/trace.json").read_text())["traceEvents"]
    return sum(e["dur"] for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
               and any(n in e["name"] for n in names)) / 1e3


def grid_sample_phase(calls: list, dev: torch.device) -> dict:
    """[grid-sample]: the kernels on every recorded call, with the model's
    layouts: the image gradient bitwise equal to grid_sample_bwd_fixed_plain
    at the kernel's scale, and on a warp level the owner and scatter routes
    (each forced) bitwise equal to it, the device escape count 0 and equal
    to escape_count_plain, the route the one its size picks (owner from
    OWNER_MIN_PIXELS up); against F.grid_sample (output rtol = atol = RTOL,
    gradients at the backward limits); a rerun bitwise equal. Printed per
    call: the forward and backward ms, the route and the backward's kernel
    launches; over the calls, the kernels' forward + backward ms beside
    F.grid_sample's (forward + autograd backward) and its plain version's,
    and the bytes bound (inputs read once, outputs written once)."""
    k = gs.grid_sample_kernels
    gen = torch.Generator(device=dev).manual_seed(11)

    def cotangent(img, grid):  # as autograd hands it over: in the image's layout
        n, c, (ho, wo) = img.shape[0], img.shape[3], grid.shape[1:3]
        if gs.channels_first(img):
            return torch.randn((n, c, ho, wo), device=dev, generator=gen).permute(0, 2, 3, 1)
        return torch.randn((n, ho, wo, c), device=dev, generator=gen)

    gouts = [cotangent(img, grid) for _, img, grid, _ in calls]
    worst_out = worst_grad = 0.0
    shapes, per_call = [], []
    for (site, img, grid, align), gout in zip(calls, gouts):
        out = k.forward(img, grid, align)
        before = (k.bwd_kernels, k.owner_launches)
        gimg, ggrid = k.backward(img, grid, gout, align)
        nkernels = k.bwd_kernels - before[0]
        route = "owner" if k.owner_launches > before[1] else "scatter"
        scale = k.last_scale.clone()
        out2 = k.forward(img, grid, align)
        gimg2, ggrid2 = k.backward(img, grid, gout, align)
        if not (torch.equal(out, out2) and torch.equal(gimg, gimg2) and torch.equal(ggrid, ggrid2)):
            raise AssertionError(f"grid-sample {site} {tuple(img.shape)}: a rerun differs")
        warp_level = grid.shape[1:3] == img.shape[1:3]
        with plain_check():
            ref, rimg, rgrid = plain_grid_sample(img, grid, align, gout)
            fixed = gs.grid_sample_bwd_fixed_plain(img, grid, gout, scale, align)
            if warp_level:
                p = gs.owner_plan(img.shape[0], *img.shape[1:], grid.stride(0) == 0)
                escapes = gs.escape_count_plain(grid, *img.shape[1:3], p["tw"], p["th"],
                                                align_corners=align)
        if not torch.equal(gimg, fixed):
            raise AssertionError(f"grid-sample {site}: d_img differs from the plain fixed-point "
                                 f"sum in {int((gimg != fixed).sum())} cells")
        if warp_level:
            for forced in ("owner", "scatter"):
                if not torch.equal(k.backward(img, grid, gout, align, route=forced)[0], gimg):
                    raise AssertionError(f"grid-sample {site}: the {forced} route differs")
                if forced == "owner" and (int(k.last_count) != 0 or escapes != 0):
                    raise AssertionError(f"grid-sample {site}: escape count {int(k.last_count)} "
                                         f"(plain {escapes}): the owner route stood down")
            want = "owner" if img.shape[1] * img.shape[2] >= gs.OWNER_MIN_PIXELS else "scatter"
            if route != want:
                raise AssertionError(f"grid-sample {site}: the {route} route, not the {want} one")
        worst_out = max(worst_out, check_close(f"grid-sample {site} out", out, ref))
        worst_grad = max(worst_grad, check_grad(f"grid-sample {site} d_img", gimg, rimg),
                         check_grad(f"grid-sample {site} d_grid", ggrid, rgrid))
        shapes.append(f"{site}:{tuple(img.shape)}->{tuple(grid.shape[1:3])}")
        fwd_ms = cuda_ms(lambda: k.forward(img, grid, align), reps=5)
        bwd_ms = cuda_ms(lambda: k.backward(img, grid, gout, align), reps=5)
        per_call.append(dict(site=site, img=list(img.shape), img_strides=list(img.stride()),
                             grid=list(grid.shape[1:3]), grid_strides=list(grid.stride()),
                             fwd_ms=round(fwd_ms, 4), bwd_ms=round(bwd_ms, 4), route=route,
                             bwd_kernels=nkernels))
    fixed_point.check(dev)
    for row in per_call:
        log("grid-sample-call", **row)

    def kernels():
        for (_, img, grid, align), gout in zip(calls, gouts):
            k.forward(img, grid, align)
            k.backward(img, grid, gout, align)

    def plain():
        for (_, img, grid, align), gout in zip(calls, gouts):
            plain_grid_sample(img, grid, align, gout)

    def library_on(leaves, gouts):
        def run():
            for ((_, _, _, align), (img, grid)), gout in zip(zip(calls, leaves), gouts):
                out = torch.nn.functional.grid_sample(img.permute(0, 3, 1, 2), grid,
                                                      align_corners=align)
                torch.autograd.grad(out, (img, grid), gout.permute(0, 3, 1, 2))
        return run

    # F.grid_sample on the model's layouts, and on contiguous copies of the
    # same inputs (the layout an earlier recorder timed it on)
    leaves = [(img.requires_grad_(), grid.requires_grad_()) for _, img, grid, _ in calls]
    contig = [(img.detach().contiguous().requires_grad_(),
               grid.detach().contiguous().requires_grad_()) for _, img, grid, _ in calls]
    kernel_ms = cuda_ms(kernels, reps=5)
    device_ms = profiled_kernel_ms(kernels, GS_KERNELS)
    k.reset()  # the phase's launches are not a main path's
    with plain_check():
        plain_ms = cuda_ms(plain, reps=5)
        library_ms = cuda_ms(library_on(leaves, gouts), reps=5)
        library_contig_ms = cuda_ms(library_on(contig, [g.contiguous() for g in gouts]), reps=5)
    del contig
    for img, grid in leaves:
        img.requires_grad_(False), grid.requires_grad_(False)
    # forward: img, grid, out; backward: + gout, gimg, ggrid (one per batch
    # item). A grid shared by the batch (batch stride 0) is read once a pass;
    # bytes_grid_per_item counts it once per batch item, as for a contiguous
    # copy of the grid.
    def nbytes_of(grid_read):
        return sum(4 * (2 * img.numel() + 2 * grid_read(grid) + 2 * gout.numel())
                   + 4 * (img.numel() + grid.numel())
                   for (_, img, grid, _), gout in zip(calls, gouts))

    nbytes = nbytes_of(lambda g: g[:1].numel() if g.stride(0) == 0 else g.numel())
    nbytes_per_item = nbytes_of(lambda g: g.numel())
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    warp_kernels = max(r["bwd_kernels"] for r in per_call if r["route"] == "owner")
    log("grid-sample", calls=len(calls), shapes=json.dumps(shapes), max_abs_err=worst_out,
        max_rel_err_grad=worst_grad, rerun_bitwise_equal=True, d_img_bitwise_fixed_plain=True,
        routes_bitwise_equal=True, kernel_ms=round(kernel_ms, 4),
        kernel_device_ms=round(device_ms, 4),
        fwd_ms_sum=round(sum(r["fwd_ms"] for r in per_call), 4),
        bwd_ms_sum=round(sum(r["bwd_ms"] for r in per_call), 4), plain_ms=round(plain_ms, 4),
        library_ms=round(library_ms, 4), library_contiguous_ms=round(library_contig_ms, 4),
        bytes=nbytes, bound_ms=round(bound_ms, 5), bytes_grid_per_item=nbytes_per_item,
        bound_ms_grid_per_item=round(nbytes_per_item / HBM_BYTES_PER_S * 1e3, 5),
        bwd_kernels_per_warp_call=warp_kernels,
        bwd_kernels_per_vertex_call=max(r["bwd_kernels"] for r in per_call
                                        if r["route"] == "scatter"))
    if warp_kernels > 5:
        raise AssertionError(f"grid-sample: a warp level's backward launched {warp_kernels} "
                             f"kernels (at most 5)")
    return dict(max_abs_err=max(worst_out, worst_grad), ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by="bytes",
                bwd_kernels_per_warp_call=warp_kernels, device_ms=device_ms,
                library_contiguous_ms=library_contig_ms,
                bound_ms_grid_per_item=nbytes_per_item / HBM_BYTES_PER_S * 1e3)


# ---------------------------------------------------------------------------
# phases 9-11: the compacted marcher, its backend in training, the benchmark
# ---------------------------------------------------------------------------

XLA_COS, XLA_REL = 0.9999, 1e-3  # the compacted marcher's gradients vs the kernels'
XLA_MAX_HIT_CAP, XLA_MAX_SAMPLES_CAP = 1024, 8192
# tiles x samples per checkpointed chunk: 8x mvp_raymarch_xla's defaults (64
# tiles x 128), fewer chunks for the same peak order (~11 GiB with gradients)
XLA_CHUNK_SAMPLES = 8 * 64 * 128


def xla_march(dev: torch.device):
    """[xla-march]: the compacted marcher on the card at full width, on
    kbench's shell scene (4 x 512x334 rays, 16,384 primitives of 8^3), held
    to the CUDA kernels by ``kbench.compare_with_kernels``. max_hit is raised
    until neither cull fills a tile and max_samples until no ray overflows:
    the two then march the same samples. Timed: forward, forward + backward
    (CUDA events, the gradients of primpos, primrot, primscale and template),
    peak GiB, beside the CUDA op at the same settings."""
    s = kbench.make_flagship_scene()
    t = kbench.scene_tensors(s, dev)
    dt, tile = s["stepsize"], FLAGSHIP["tile"]
    rp, rd, tmm = t["raypos"], t["raydir"], t["tminmax"]
    leaves = ("primpos", "primrot", "primscale", "template")

    def overflow(max_hit, max_samples):
        with torch.no_grad():
            return int(march_compacted(
                rp, rd, dt, tmm, *(t[k] for k in leaves[:3]), t["template"], tile=tile,
                max_hit=max_hit, max_samples=max_samples,
                chunk_tiles=max(1, XLA_CHUNK_SAMPLES // max_samples))[1])

    # the flagship configuration's own settings, for information
    overflow_cfg = overflow(FLAGSHIP["max_hit"], 96)
    max_hit = FLAGSHIP["max_hit"]
    while kbench.truncated_tiles(t, dt, tile, max_hit):
        if max_hit >= XLA_MAX_HIT_CAP:
            raise AssertionError(f"xla-march: a cull still fills a tile at max_hit {max_hit}")
        max_hit *= 2
    max_samples = 96
    while overflow(max_hit, max_samples):
        if max_samples >= XLA_MAX_SAMPLES_CAP:
            raise AssertionError(f"xla-march: rays still overflow at max_samples {max_samples}")
        max_samples *= 2
    chunk = max(1, XLA_CHUNK_SAMPLES // max_samples)
    rep = kbench.compare_with_kernels(t, dt, tile=tile, max_hit=max_hit,
                                      max_samples=max_samples, chunk_tiles=chunk)
    if rep["truncated_tiles"] or rep["overflow_rays"]:
        raise AssertionError(f"xla-march: the two did not march the same samples: {rep}")
    # alpha elementwise; the images of the free rays to 1e-4 of their
    # largest value plus 1e-4 (the port's image tolerance for whole models):
    # a sample on a box face, taken by one of the two roundings only, moves
    # a dim ray's colour by ~1e-4 (see kbench.compare_with_kernels)
    image_lim = 1e-4 * rep["image_max_abs_ref_free"] + 1e-4
    if rep["alpha_beyond_1e-4"] or rep["image_max_abs_err_free"] > image_lim:
        raise AssertionError(f"xla-march: images beyond 1e-4: {rep}")
    # every gradient by its cosine; the template's also by max |d| (the
    # geometric ones move with the face samples, printed as measured)
    bad = {k: v for k, v in rep.items() if (k.endswith("_cos") and not v > XLA_COS)
           or (k in ("grad_template_rel_err", "grad_warp_rel_err") and not v <= XLA_REL)}
    if bad:
        raise AssertionError(f"xla-march: gradients beyond cosine {XLA_COS} / max |d| "
                             f"{XLA_REL} max |ref|: {bad}")

    def fwd_xla(*x):
        return march_compacted(rp, rd, dt, tmm, *x[:3], x[3], tile=tile, max_hit=max_hit,
                               max_samples=max_samples, chunk_tiles=chunk)[0]

    def fwd_cuda(*x):
        return rc.mvp_raymarch_cuda(rp, rd, dt, tmm, *x[:3], x[3], tile=tile, max_hit=max_hit,
                                    nbuf=rep["nbuf"], device=dev)

    def grad(fwd):
        x = [t[k].detach().requires_grad_() for k in leaves]
        return torch.autograd.grad(torch.sum(fwd(*x)), x)

    # both ran at these settings in the comparison: no warm-up call here
    times = {}
    for name, fwd, reps in (("xla", fwd_xla, 1), ("cuda_op", fwd_cuda, 3)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        with torch.no_grad():
            times[f"{name}_fwd_ms"] = cuda_ms(lambda: fwd(*(t[k] for k in leaves)), reps=reps)
        times[f"{name}_fwd_bwd_ms"] = cuda_ms(lambda: grad(fwd), reps=reps)
        times[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    log("xla-march", scene="kbench shell 4x512x334, 16384 x 8^3", tile=tile, max_hit=max_hit,
        max_samples=max_samples, chunk_tiles=chunk, overflow_rays=rep["overflow_rays"],
        overflow_rays_at_config_max_samples_96_max_hit_64=overflow_cfg,
        **{k: round(v, 3) for k, v in times.items()},
        image_limit_free=image_lim,
        **{k: v for k, v in rep.items() if k not in ("overflow_rays",)})
    return dict(times, max_hit=max_hit, max_samples=max_samples, overflow_cfg=overflow_cfg,
                free_share=rep["free_share"])


def xla_262k(dev: torch.device) -> dict:
    """[xla-262k]: whether the compacted marcher fits at 262,144 primitives:
    kbench's shell scene with 2^3 boxes at the 262k configuration's tile,
    max_hit, max_samples and chunk_tiles, a forward and then a forward +
    backward. Its cull holds [tiles, K] tensors (2,688 x 262,144 here): an
    out-of-memory error is the answer, reported with the peak, not raised
    (the configuration runs on the CUDA kernels)."""
    rm = load_config(CONFIG262K_YAML).model.raymarch
    s = kbench.make_flagship_scene(nprims=262144, boxsize=2)
    t = kbench.scene_tensors(s, dev)
    leaves = ("primpos", "primrot", "primscale", "template")
    opts = dict(tile=rm.tile, max_hit=rm.max_hit, max_samples=rm.max_samples,
                chunk_tiles=rm.chunk_tiles)
    res = {}
    for what in ("forward", "forward_backward"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        try:
            x = [t[k].detach().requires_grad_(what != "forward") for k in leaves]
            with torch.set_grad_enabled(what != "forward"):
                out, over = march_compacted(t["raypos"], t["raydir"], s["stepsize"],
                                            t["tminmax"], *x[:3], x[3], **opts)
            if what != "forward":
                torch.autograd.grad(torch.sum(out), x)
            torch.cuda.synchronize()
            res[what] = dict(fits=True, seconds=round(time.perf_counter() - t0, 3),
                             overflow_rays=int(over))
        except torch.OutOfMemoryError as err:
            res[what] = dict(fits=False, error=str(err).splitlines()[0][:160])
        res[what]["peak_gib"] = round(torch.cuda.max_memory_allocated(dev) / 2**30, 3)
        x = out = over = None
    log("xla-262k", scene="kbench shell 4x512x334, 262144 x 2^3", **opts,
        **{k: json.dumps(v) for k, v in res.items()})
    return res


def xla_train(dev: torch.device, work: Path):
    """[xla-train]: cli.train on the flagship yaml with
    ``model.raymarch.backend=xla`` for 2 steps: finite losses, moved
    parameters, no march kernel launched (the compacted marcher is PyTorch);
    printed: the StepTimer ms and p50, the peak GiB and the overflow warnings
    at the yaml's max_samples (96)."""
    argv = ["--config", FLAGSHIP_YAML, "--device", str(dev), f"assets={work / 'assets'}",
            f"progress.output_path={work / 'xla_run'}", "model.raymarch.backend=xla",
            "train.maxiter=2"]
    first = {}
    torch.cuda.reset_peak_memory_stats(dev)
    reset_march_launches()  # this path starts here
    t0 = time.perf_counter()
    with LogLines() as log_lines, Watched() as watched:
        make = loop.make_train_step

        def keep_first(model, *args, **kwargs):
            first["params"] = [p.detach().clone() for p in model.parameters()]
            return make(model, *args, **kwargs)

        loop.make_train_step = keep_first
        try:
            state = cli_train.main(argv)
        finally:
            loop.make_train_step = make
    launches = march_launches()  # this path ends here
    GRID_LAUNCHES["xla_train"] = grid_launches()
    seconds = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    if state.model.raymarcher.backend != "xla" or state.step != 2 or len(watched.steps) != 2:
        raise AssertionError(f"xla-train: backend {state.model.raymarcher.backend}, step "
                             f"{state.step}, {len(watched.steps)} steps")
    if launches != (0, 0, 0):
        raise AssertionError(f"xla-train: the xla backend launched march kernels: {launches}")
    if not all(np.isfinite(v) for v in watched.losses):
        raise AssertionError(f"xla-train: losses {watched.losses}")
    params = list(state.model.parameters())
    if not all(bool(torch.isfinite(p).all()) for p in params) or all(
            torch.equal(p.detach(), q) for p, q in zip(params, first["params"])):
        raise AssertionError("xla-train: non-finite or unchanged parameters")
    over = [int(m.group(1)) for ln in log_lines.lines
            if (m := re.match(r"mvp_raymarch_xla: (\d+) rays exceeded", ln))]
    ms = watched.ms(0)
    log("xla-train", config=FLAGSHIP_YAML, backend="xla", steps=2, losses=watched.losses,
        steptimer_ms=ms, steptimer_p50_ms=round(float(np.median(ms)), 3),
        overflow_warnings=len(over), overflow_rays_per_march=over, peak_gib=round(peak_gib, 3),
        fwd_launches=launches[0], bwd_launches=launches[1], seconds=round(seconds, 3))
    return launches, float(np.median(ms))


def child_json(cmd, phase: str, timeout: int = 600) -> list:
    """Run ``cmd`` from the checkout's root; the JSON lines of its stdout."""
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    if res.returncode != 0:
        raise AssertionError(f"{phase}: {' '.join(cmd)} exited {res.returncode}:\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith("{")]


def numbers(x) -> list:
    if isinstance(x, dict):
        return [v for item in x.values() for v in numbers(item)]
    if isinstance(x, list):
        return [v for item in x for v in numbers(item)]
    return [x] if isinstance(x, (int, float)) and not isinstance(x, bool) else []


BENCH_TIMING = ("steps", "blocked_s", "pipelined_s", "chained_s", "blocked_median_s",
                "pipelined_median_s", "chained_mean_s", "noop_roundtrip_s", "noop_chained_s",
                "device")
BENCH_RAYMARCH = ("fwd_s", "bwd_s", "bwd_over_fwd", "mrays_per_s_fwd", "x_hbm_speed_of_light",
                  "cull_s", "candidates", "alpha_mean", "scene")


def bench_phase():
    """[bench]: ``python -m ava256_tpu_torch.bench`` at its defaults in a
    child process (its JSON line printed under the tag), then ``python -m
    ava256_tpu_torch.kbench --verify`` (the kernels against the oracle on the
    reduced scene; it exits 1 if they disagree). Returns the bench's line."""
    t0 = time.perf_counter()
    line, = child_json([sys.executable, "-m", "ava256_tpu_torch.bench"], "bench")
    seconds = time.perf_counter() - t0
    if set(line) != {"metric", "value", "unit", "vs_baseline", "timing", "raymarch"} or \
            line["metric"] != "train_steps_per_sec_per_chip_b4_512x334" or \
            any(k not in line["timing"] for k in BENCH_TIMING) or \
            any(k not in line["raymarch"] for k in BENCH_RAYMARCH):
        raise AssertionError(f"bench: keys of {line}")
    if not all(np.isfinite(v) for v in numbers(line)) or not line["value"] > 0:
        raise AssertionError(f"bench: values of {line}")
    steps = line["timing"]["steps"]
    GRID_LAUNCHES["bench"] = tuple(line["timing"]["grid_sample_launches"])
    if line["timing"]["march_launches"] != [2 + 3 * steps] * 2 or min(GRID_LAUNCHES["bench"]) < 1:
        raise AssertionError(f"bench: march launches {line['timing']['march_launches']}, "
                             f"grid-sample launches {GRID_LAUNCHES['bench']} in "
                             f"{2 + 3 * steps} steps")
    print(f"[bench] {json.dumps(line)}", flush=True)
    log("bench-run", seconds=round(seconds, 3))
    t0 = time.perf_counter()
    rep, verify = child_json([sys.executable, "-m", "ava256_tpu_torch.kbench", "--verify"],
                             "kbench")
    log("kbench", seconds=round(time.perf_counter() - t0, 3), report=json.dumps(rep),
        verify=json.dumps(verify))
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    # the entry points' log lines go to stderr (they also set up logging)
    logging.basicConfig(stream=sys.stderr, level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    smi = nvidia_smi()
    log("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, smi=repr(smi))

    t0 = time.perf_counter()
    libs = [rc.MARCH_FWD_LIB, rc.MARCH_BWD_LIB, gs.GRID_SAMPLE_LIB, native.DATAIO_LIB]
    build_all(libs)
    ptxas = [ln.strip() for lib in libs for ln in lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", seconds=round(time.perf_counter() - t0, 3), ptxas=ptxas,
        libs=[lib.path.name for lib in libs])

    small_err = small_scenes(dev)
    log("small-scenes", max_abs_err=small_err)
    small_bwd_err = small_scenes_bwd(dev)
    log("small-scenes-bwd", max_rel_err=small_bwd_err, tol=BWD_TOL)

    model, ds, batches, mi, render_launches, fwd_ms = flagship_render(dev)
    train_launches, step_ms = flagship_train(model, ds, batches, dev)
    gsk = grid_sample_phase(record_grid_samples(model, batches[0], dev), dev)
    traceprof_launches = traceprof_phase(model, ds, batches[0], dev)
    del model, batches
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        os.environ["AVA256_CACHE_DIR"] = str(work / "cache")  # the UV maps' cache
        loop_launches = flagship_loop(dev, work, step_ms)
        torch.cuda.empty_cache()
        cli_launches = flagship_cli(dev, work)
        torch.cuda.empty_cache()
        steady_launches, steady = flagship_loop_steady(dev, work, step_ms)
        torch.cuda.empty_cache()
        bf16_train_launches = bf16_train(dev, work, steady)
        torch.cuda.empty_cache()
        bf16_cli_launches = bf16_cli(dev, work)
        torch.cuda.empty_cache()
        turns_launches = dtype_turns(dev, work)
        torch.cuda.empty_cache()
        xla_train_launches, xla_step_ms = xla_train(dev, work)
        torch.cuda.empty_cache()
        repeat_launches = repeat(dev, work)
        torch.cuda.empty_cache()
        resume_launches = resume_exact(dev, work)
        torch.cuda.empty_cache()
        long_launches = long_recipe(dev, work)
        torch.cuda.empty_cache()
        latent_launches = latent(dev, work)
        torch.cuda.empty_cache()
        csv = capture_write(work)
        demos_phase(work, csv)
        img_hw = capture_io(work, csv)
        loaderbench_phase()
        capture_launches = capture_train(dev, work, csv, img_hw, steady)
        torch.cuda.empty_cache()
        capture_cli_launches = capture_cli(dev, work, csv, img_hw)
        torch.cuda.empty_cache()
        ddp_launches, state262k = ddp_train(dev, work)
        k262, kb262 = kernel_262k(state262k.model, dev)
        del state262k
    torch.cuda.empty_cache()
    args, state, plain_state, boxes, samples, k = flagship_kernel(mi, dev)
    kb = flagship_kernel_bwd(args, state, plain_state, boxes, samples, dev)
    del args, state, plain_state, mi
    torch.cuda.empty_cache()
    fwdprof_launches = fwdprof_phase(dev)
    torch.cuda.empty_cache()
    xla = xla_march(dev)
    torch.cuda.empty_cache()
    xla_262k(dev)
    torch.cuda.empty_cache()
    bench_line = bench_phase()
    bench_launches = bench_line["timing"]["march_launches"]

    src = "ava256_tpu_torch/csrc/"
    table = {"kernels": [
        dict(name="mvp_march_fwd", route="cuda", source=src + "mvp_march_fwd.cu",
             replaces="ava256_tpu/ops/raymarch_pallas.py:831",
             launches=render_launches + train_launches[0] + loop_launches[0] + cli_launches[0]
             + steady_launches[0] + bf16_train_launches[0] + bf16_cli_launches[0]
             + turns_launches[0] + repeat_launches[0] + resume_launches[0]
             + capture_launches[0] + capture_cli_launches[0]
             + ddp_launches[0] + xla_train_launches[0] + bench_launches[0]
             + traceprof_launches[0] + long_launches[0] + latent_launches[0]
             + fwdprof_launches[0],
             launches_render=render_launches, launches_train=train_launches[0],
             launches_loop=loop_launches[0], launches_cli=cli_launches[0],
             launches_loop_steady=steady_launches[0],
             launches_bf16_train=bf16_train_launches[0], launches_bf16_cli=bf16_cli_launches[0],
             launches_dtype_turns=turns_launches[0], launches_repeat=repeat_launches[0],
             launches_resume_exact=resume_launches[0],
             launches_capture_train=capture_launches[0],
             launches_capture_cli=capture_cli_launches[0], launches_ddp_train=ddp_launches[0],
             launches_xla_train=xla_train_launches[0], launches_bench=bench_launches[0],
             launches_traceprof=traceprof_launches[0], launches_long_recipe=long_launches[0],
             launches_latent=latent_launches[0], launches_fwdprof=fwdprof_launches[0],
             max_abs_err=max(small_err, k["max_abs_err"], k262["max_abs_err"]),
             ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"],
             library_ms=None,
             # ms is the kernel as a render calls it; a training step also asks
             # for the rays' saturation state
             ms_with_state=k["ms_with_state"],
             # the same on the 262k configuration's scene (262,144 primitives of 2^3)
             ms_262k=k262["ms"], ms_with_state_262k=k262["ms_with_state"],
             plain_ms_262k=k262["plain_ms"], bound_ms_262k=k262["bound_ms"],
             bound_by_262k=k262["bound_by"]),
        dict(name="mvp_march_bwd", route="cuda", source=src + "mvp_march_bwd.cu",
             replaces="ava256_tpu/ops/raymarch_pallas.py:908",
             launches=train_launches[1] + loop_launches[1] + cli_launches[1]
             + steady_launches[1] + bf16_train_launches[1] + bf16_cli_launches[1]
             + turns_launches[1] + repeat_launches[1] + resume_launches[1]
             + capture_launches[1] + capture_cli_launches[1]
             + ddp_launches[1] + xla_train_launches[1] + bench_launches[1]
             + traceprof_launches[1] + long_launches[1] + latent_launches[1],
             launches_train=train_launches[1], launches_loop=loop_launches[1],
             launches_cli=cli_launches[1], launches_loop_steady=steady_launches[1],
             launches_bf16_train=bf16_train_launches[1], launches_dtype_turns=turns_launches[1],
             launches_repeat=repeat_launches[1], launches_resume_exact=resume_launches[1],
             launches_capture_train=capture_launches[1],
             launches_capture_cli=capture_cli_launches[1], launches_ddp_train=ddp_launches[1],
             launches_xla_train=xla_train_launches[1], launches_bench=bench_launches[1],
             launches_traceprof=traceprof_launches[1], launches_long_recipe=long_launches[1],
             launches_latent=latent_launches[1],
             # launches that were handed the forward's saved state (all of them)
             launches_with_state=train_launches[2] + loop_launches[2] + steady_launches[2]
             + bf16_train_launches[2] + turns_launches[2] + repeat_launches[2]
             + resume_launches[2] + capture_launches[2] + ddp_launches[2]
             + traceprof_launches[2] + long_launches[2] + latent_launches[2],
             max_abs_err=max(small_bwd_err, kb["max_abs_err"], kb262["max_abs_err"]), ms=kb["ms"],
             plain_ms=kb["plain_ms"], bound_ms=kb["bound_ms"], bound_by=kb["bound_by"],
             library_ms=None,
             # ms is the kernel on all tiles with the forward's saved state, as a
             # training step calls it, ms_without_state with the forward kernel
             # run first for it; plain_ms is the plain version on plain_tiles
             # of the tiles, ms_on_plain_tiles the kernel on the same
             tiles=kb["tiles"], plain_tiles=kb["plain_tiles"],
             ms_on_plain_tiles=kb["ms_on_plain_tiles"],
             ms_without_state=kb["ms_without_state"],
             two_march_ops_ms=kb["two_march_ops_ms"],
             # the same on the 262k configuration's scene
             ms_262k=kb262["ms"], plain_ms_262k=kb262["plain_ms"],
             bound_ms_262k=kb262["bound_ms"], bound_by_262k=kb262["bound_by"],
             tiles_262k=kb262["tiles"], plain_tiles_262k=kb262["plain_tiles"],
             ms_on_plain_tiles_262k=kb262["ms_on_plain_tiles"],
             ms_without_state_262k=kb262["ms_without_state"]),
        dict(name="grid_sample", route="cuda", source=src + "grid_sample.cu",
             # F.grid_sample on the card; JAX samples with XLA gathers there
             replaces="ava256_tpu/ops/grid_sample.py:34 (no pallas_call)",
             launches=sum(f + b for f, b in GRID_LAUNCHES.values()),
             launches_fwd=sum(f for f, _ in GRID_LAUNCHES.values()),
             launches_bwd=sum(b for _, b in GRID_LAUNCHES.values()),
             launches_by_path=GRID_LAUNCHES,
             # backward calls of the main paths (bench and the DDP child aside) by
             # route, the kernels they launched, and the owner-route calls whose
             # escape count sent them to the scatter route (a device count)
             bwd_calls_by_route=dict(owner=GRID_ROUTES["owner"],
                                     scatter=GRID_ROUTES["scatter"]),
             bwd_kernels=GRID_ROUTES["bwd_kernels"],
             owner_fallbacks=gs.grid_sample_kernels.fallbacks(),
             bwd_kernels_per_warp_call=gsk["bwd_kernels_per_warp_call"],
             # ms, plain_ms, library_ms: forward + backward over one training
             # forward's calls (the pyramids' levels and the vertex sampling)
             max_abs_err=gsk["max_abs_err"], ms=gsk["ms"], plain_ms=gsk["plain_ms"],
             bound_ms=gsk["bound_ms"], bound_by=gsk["bound_by"],
             # the bound with the shared warp grid read once per batch item
             bound_ms_grid_per_item=gsk["bound_ms_grid_per_item"],
             library_ms=gsk["library_ms"],
             # the same calls' kernel time on the device (torch.profiler), and
             # F.grid_sample on contiguous copies of their inputs
             device_ms=gsk["device_ms"], library_contiguous_ms=gsk["library_contiguous_ms"])]}
    if min(sum(v) for v in GRID_LAUNCHES.values()) < 1:
        raise AssertionError(f"a main path did not launch the grid-sample kernels: {GRID_LAUNCHES}")
    log("done", seconds=round(time.perf_counter() - t_start, 3), ms_per_forward=fwd_ms,
        ms_per_train_step=step_ms, xla_train_p50_ms=xla_step_ms,
        xla_march_fwd_ms=round(xla["xla_fwd_ms"], 3),
        bench_steps_per_s_per_chip=bench_line["value"])
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-child"]:  # [ddp-train]'s and [long-recipe]'s processes
        sys.exit(train_child(Path(sys.argv[2]), sys.argv[4:]))
    sys.exit(main())
