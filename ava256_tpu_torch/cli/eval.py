# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Reconstruction quality of a checkpoint, as ``eval.py``: reconstructs N
items (self-driven, deterministic latents) and prints mean PSNR / SSIM /
LPIPS as one JSON line (``lpips_rf`` for the random-feature LPIPS).

    python -m ava256_tpu_torch.cli.eval --config configs/config-synthetic-flagship.yaml \\
        --checkpoint RUN/checkpoints --holdout-cameras 2 --opts assets=DIR
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np

from ava256_tpu_torch.cli.common import add_device_arg, restore
from ava256_tpu_torch.config import load_config
from ava256_tpu_torch.data.dataset import none_collate
from ava256_tpu_torch.data.loader import Uploader
from ava256_tpu_torch.ops.raymarch_cuda import resolve_device
from ava256_tpu_torch.render import decode
from ava256_tpu_torch.train.loop import build_dataset, to_model_batch
from ava256_tpu_torch.train.metrics import lpips, lpips_weights_path, psnr, ssim
from ava256_tpu_torch.utils import setup_logging

logger = logging.getLogger("ava256_tpu_torch.cli")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate reconstruction quality")
    parser.add_argument("--config", default="configs/config.yaml")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--num-items", type=int, default=32)
    parser.add_argument("--stride", type=int, default=1)
    parser.add_argument(
        "--holdout-cameras", type=int, default=0,
        help="evaluate ONLY on the last N cameras (the held-out split); "
        "train with data.holdout_cameras=N so they never appear in training",
    )
    parser.add_argument("--opts", default=[], nargs="+")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    cfg = load_config(args.config, args.opts)
    setup_logging()
    device = resolve_device(args.device)
    if args.holdout_cameras:
        cfg.data.holdout_cameras = args.holdout_cameras
    dataset = build_dataset(cfg, heldout=bool(args.holdout_cameras))
    state = restore(cfg, dataset, args.checkpoint, device)
    upload = Uploader(device)

    psnrs, ssims, lpipss, n_done, seconds = [], [], [], 0, 0.0
    for idx in range(0, len(dataset), args.stride):
        if n_done >= args.num_items:
            break
        item = dataset[idx]
        if item is None:
            continue
        mb = upload.now(to_model_batch(none_collate([item])))
        t0 = time.time()
        rec = decode(state.model, mb, mb["neut_avgtex"], mb["neut_verts"])
        psnrs.append(float(psnr(rec, mb["image"])))
        ssims.append(float(ssim(rec, mb["image"])))
        lpipss.append(float(lpips(rec, mb["image"])))
        seconds += time.time() - t0
        n_done += 1
    logger.info("Evaluated %d items: %.1f ms per item (reconstruction and metrics)", n_done,
                seconds / max(n_done, 1) * 1e3)

    # trained AlexNet weights report as "lpips", the random-feature metric as
    # "lpips_rf": never compare the latter with other stacks' LPIPS
    lpips_key = "lpips" if lpips_weights_path() else "lpips_rf"
    result = {
        "metric": "reconstruction_quality",
        "split": "heldout_cameras" if args.holdout_cameras else "train",
        "items": n_done,
        "psnr_db": round(float(np.mean(psnrs)), 3),
        "ssim": round(float(np.mean(ssims)), 4),
        lpips_key: round(float(np.mean(lpipss)), 6),
        "checkpoint_step": int(state.step),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
