# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Benchmark: flagship train-step throughput on one card, the port of the
repository's ``bench.py``.

    python -m ava256_tpu_torch.bench [--device cuda]

Prints ONE JSON line with ``bench.py``'s keys and metric name: ``metric``,
``value`` (train steps/s per chip at batch 4 and 512x334 rays), ``unit``,
``vs_baseline``, ``timing`` (the step times in three dispatch modes, two
no-op probes, the device; and, beyond ``bench.py``'s keys, the march
kernels' launches) and ``raymarch`` (``kbench`` on the step's own
scene: the march's forward and backward seconds, Mrays/s, the multiple of
the HBM speed of light, the cull, the candidates, the mean alpha).

Baseline: the reference publishes no throughput; its 4-identity config
trains ~300k iterations in 1.5 days on 16 A100s at batch 4 per GPU
(BASELINE.md), 300000 / (1.5 * 86400) / 16 = 0.1447 train steps/s per GPU.
That is the reference's 16-A100 figure, not a TPU number. ``vs_baseline``
is the steps/s per chip here at the same per-chip batch and ray count over
it. ``n_chips`` is 1: one process drives one card.

The model: ``factory.get_autoencoder`` at 1024^2 textures, the topology
``.obj`` named by ``AVA256_TOPOLOGY`` if that file exists, else the seeded
random topology of ``data.synthetic.synthetic_uvdata``; the synthetic
dataset's first items as the batch; Adam 2e-4 with the clip, the four loss
weights of ``bench.py``; the march on the CUDA kernels (tile 16, max_hit
64). One warm-up step with the training warm-up switches
(``running_avg_scale``, ground-truth geometry, residuals off: without it
the primitives' scale is zero), then one normal step, then ``steps`` steps
in each mode:

- blocked: the loss fetched to the host after every step;
- pipelined: after launching step i, wait for step i-1's loss (how the
  training loop runs, whose log line trails the launch). Where a step
  synchronizes inside, this equals blocked;
- chained: one sync at the end.

The headline is the pipelined median. The no-op probes time a one-element
``x + 1``, synchronized after every call and chained.

Env knobs, as ``bench.py``'s: AVA256_BENCH_STEPS (5), AVA256_BENCH_BATCH
(4), AVA256_BENCH_NPRIMS (16384), AVA256_BENCH_PRIMSIZE (8; 2 pairs with
262144), AVA256_BENCH_HW ("512x334"), AVA256_BENCH_RAYMARCH (1; 0 skips the
march measurement), AVA256_BENCH_SAVE_MARCH (a path: the march operands as
an .npz for ``python -m ava256_tpu_torch.kbench --scene``).

It runs on the card unless ``--device cpu`` is given, and never falls back
to the CPU: without a card ``--device cuda`` raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ava256_tpu_torch.data.loader import Uploader
from ava256_tpu_torch.data.synthetic import SyntheticDataset, none_collate, synthetic_uvdata
from ava256_tpu_torch.factory import get_autoencoder
from ava256_tpu_torch.geometry import create_uv_baridx
from ava256_tpu_torch.kbench import measure_raymarch_arrays, sync
from ava256_tpu_torch.ops import grid_sample as gs
from ava256_tpu_torch.ops import raymarch_cuda as rc
from ava256_tpu_torch.ops.raymarch_cuda import resolve_device
from ava256_tpu_torch.render import BATCH_MODEL_KEYS
from ava256_tpu_torch.train.loop import to_model_batch
from ava256_tpu_torch.train.state import TrainState, make_optimizer
from ava256_tpu_torch.train.step import make_train_step

REFERENCE_STEPS_PER_SEC_PER_CHIP = 300000 / (1.5 * 86400) / 16  # ~0.1447, 16 A100s
LOSS_WEIGHTS = {"irgbl1": 1.0, "vertl1": 0.1, "kldiv": 1e-3, "primvolsum": 0.01}
# bench.py's; the CUDA kernels take tile and max_hit, the compacted marcher
# max_samples and chunk_tiles, rows shaped the TPU kernel
RAYMARCH_OPTIONS = {"tile": 16, "max_hit": 64, "max_samples": 96, "chunk_tiles": 128, "rows": 8}


def knobs(environ=os.environ) -> Dict[str, Any]:
    """The benchmark's settings from the environment, with bench.py's defaults."""
    h, w = map(int, environ.get("AVA256_BENCH_HW", "512x334").split("x"))
    return dict(steps=int(environ.get("AVA256_BENCH_STEPS", 5)),
                batch=int(environ.get("AVA256_BENCH_BATCH", 4)),
                nprims=int(environ.get("AVA256_BENCH_NPRIMS", 16384)),
                primsize=int(environ.get("AVA256_BENCH_PRIMSIZE", 8)), height=h, width=w,
                raymarch=environ.get("AVA256_BENCH_RAYMARCH", "1") != "0",
                save_march=environ.get("AVA256_BENCH_SAVE_MARCH") or None)


def uvdata(resolution: int) -> Dict[str, np.ndarray]:
    """The topology's UV maps: ``AVA256_TOPOLOGY`` if that file exists, else
    the seeded random topology with the flagship's vertex count."""
    obj = os.environ.get("AVA256_TOPOLOGY")
    if obj and os.path.exists(obj):
        return create_uv_baridx(obj, resolution=resolution)
    return synthetic_uvdata(resolution)


def build(texsize: int, nprims: int, height: int, width: int, batch: int, device,
          raymarch_options=None, primsize: int = 8, dtype=None):
    """(model on the CUDA kernels, batch on the device, dataset), as
    ``__graft_entry__._build`` with its 4 identities and 8 cameras; ``dtype``
    is ``get_autoencoder``'s (None: float32, or ``torch.bfloat16``)."""
    nident, ncams = 4, 8
    dataset = SyntheticDataset(nident=nident, ncams=ncams, height=height, width=width,
                               texsize=texsize)
    rm = dict(RAYMARCH_OPTIONS if raymarch_options is None else raymarch_options)
    model = get_autoencoder(uvdata(texsize), vertmean=dataset.vertmean,
                            vertstd=dataset.vertstd, ncams=ncams, nident=nident, nprims=nprims,
                            primsize=(primsize,) * 3, raymarch_backend="cuda",
                            raymarch_options=rm, device=device, dtype=dtype)
    mb = Uploader(device).now(to_model_batch(none_collate([dataset[i] for i in range(batch)])))
    return model, mb, dataset


def device_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu" on the CPU."""
    if device.type != "cuda":
        return device.type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def bench(device, steps: int = 5, batch: int = 4, nprims: int = 16384, primsize: int = 8,
          height: int = 512, width: int = 334, texsize: int = 1024, raymarch: bool = True,
          save_march: Optional[str] = None, raymarch_options=None) -> Dict[str, Any]:
    """Build, warm up and time the train step; returns the JSON line's dict."""
    device = resolve_device(device)
    h, w = height, width
    model, mb, dataset = build(texsize=texsize, nprims=nprims, height=h, width=w, batch=batch,
                               primsize=primsize, raymarch_options=raymarch_options,
                               device=device)
    optimizer = make_optimizer(model)
    train_step = make_train_step(model, optimizer, LOSS_WEIGHTS, dataset.vertmean,
                                 dataset.vertstd)
    state = TrainState(model, optimizer, 0)
    kernels = (rc.march_tiles_kernel, rc.march_tiles_bwd_kernel)
    launched = [k.launches for k in kernels]
    grid = gs.grid_sample_kernels
    grid_launched = [grid.launches, grid.bwd_launches]

    # the training warm-up protocol (sets the adaptive primitive scale),
    # then a normal step
    state, loss, _ = train_step(state, mb, running_avg_scale=True, use_gt_geo=True,
                                residuals_weight=0.0)
    float(loss)
    state, loss, _ = train_step(state, mb)
    float(loss)

    def run_mode(state, mode):
        times, pending, t0 = [], [], time.perf_counter()
        for _ in range(steps):
            state, loss, _ = train_step(state, mb)
            if mode == "blocked":
                float(loss)
            elif mode == "pipelined":
                pending.append(loss)
                if len(pending) > 1:
                    float(pending.pop(0))
            times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
        final = float(loss)
        times[-1] += time.perf_counter() - t0
        return state, final, times

    state, _, t_blocked = run_mode(state, "blocked")
    state, _, t_pipe = run_mode(state, "pipelined")
    state, final, t_chain = run_mode(state, "chained")
    if not np.isfinite(final):
        raise RuntimeError(f"non-finite loss {final}")
    launched = [k.launches - n for k, n in zip(kernels, launched)]
    grid_launched = [grid.launches - grid_launched[0], grid.bwd_launches - grid_launched[1]]

    # no-op probes: a one-element x + 1, synchronized per call and chained
    x = torch.zeros((), device=device) + 1.0
    sync(device)
    t0 = time.perf_counter()
    for _ in range(20):
        x = x + 1.0
        sync(device)
    rtt_s = (time.perf_counter() - t0) / 20
    t0 = time.perf_counter()
    for _ in range(20):
        x = x + 1.0
    sync(device)
    noop_chain_s = (time.perf_counter() - t0) / 20

    dt = float(np.median(t_pipe))
    n_chips = 1
    steps_per_sec_per_chip = (1.0 / dt) / n_chips * (batch / 4.0) * (h * w) / (512 * 334)
    timing = {
        "steps": steps,
        "blocked_s": [round(t, 4) for t in t_blocked],
        "pipelined_s": [round(t, 4) for t in t_pipe],
        "chained_s": [round(t, 4) for t in t_chain],
        "blocked_median_s": round(float(np.median(t_blocked)), 4),
        "pipelined_median_s": round(dt, 4),
        # chained has one sync at the end; only the mean is meaningful
        "chained_mean_s": round(float(np.sum(t_chain)) / steps, 4),
        "noop_roundtrip_s": round(rtt_s, 5),
        "noop_chained_s": round(noop_chain_s, 5),
        "device": device_line(device),
        # launches of the forward and backward march kernels by the 2 + 3 *
        # steps train steps (0 where the plain versions ran, on the CPU)
        "march_launches": launched,
        # the grid-sample kernels' (forward, backward) launches by those steps
        "grid_sample_launches": grid_launched,
    }

    # the march on the step's own scene: the model's march operands now
    rm_report = {}
    if raymarch:
        model.eval()
        with torch.no_grad():
            mi = model(target_neut_avgtex=mb["neut_avgtex"], target_neut_verts=mb["neut_verts"],
                       idindex=mb["idindex"], camindex=mb["camindex"], deterministic=True,
                       output_set=frozenset({"march_inputs"}),
                       **{k: mb[k] for k in BATCH_MODEL_KEYS})["march_inputs"]
        rmr = model.raymarcher
        if save_march:
            dump = {k: v.cpu().numpy() for k, v in mi.items()
                    if isinstance(v, torch.Tensor)}
            dump.update(stepsize=np.float32(rmr.dt), fadescale=np.float32(rmr.fadescale),
                        fadeexp=np.float32(rmr.fadeexp))
            np.savez(save_march, **dump)
        rep, _ = measure_raymarch_arrays(
            mi["raypos"], mi["raydir"], float(rmr.dt), mi["tminmax"], mi["primpos"],
            mi["primrot"], mi["primscale"], mi["template"], warp=mi.get("warp"),
            steps=max(steps - 2, 2), tile=int(rmr.options.get("tile", 16)),
            max_hit=int(rmr.options.get("max_hit", 64)), fadescale=rmr.fadescale,
            fadeexp=rmr.fadeexp)
        rm_report = {k: rep[k] for k in (
            "fwd_s", "bwd_s", "bwd_over_fwd", "mrays_per_s_fwd", "x_hbm_speed_of_light",
            "cull_s", "candidates", "alpha_mean", "hbm_gbps", "device")}
        rm_report["scene"] = "bench-step scene (model march operands)"

    return {
        "metric": "train_steps_per_sec_per_chip_b4_512x334" if nprims == 16384
        else f"train_steps_per_sec_per_chip_b{batch}_{h}x{w}_K{nprims}",
        "value": round(steps_per_sec_per_chip, 4),
        "unit": "steps/s/chip",
        "vs_baseline": round(steps_per_sec_per_chip / REFERENCE_STEPS_PER_SEC_PER_CHIP, 3),
        "timing": timing,
        "raymarch": rm_report,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda by default; cpu runs the plain PyTorch versions "
                         "of the kernels)")
    args = ap.parse_args(argv)
    print(json.dumps(bench(args.device, **knobs())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
