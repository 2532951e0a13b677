# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Render frames from a trained model, self-driven and cross-identity-driven,
as ``render.py``: iterates the driver identity's frames, decodes each with
the driver's own neutral conditioning and with the driven subject's, and
writes ``render_NNNN.png`` strips of [ground truth, self, cross-id].

    python -m ava256_tpu_torch.cli.render --config configs/config-synthetic-flagship.yaml \\
        --checkpoint RUN/checkpoints --num-frames 16 --output renders/ --opts assets=DIR
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import torch

from ava256_tpu_torch.cli.common import add_device_arg, restore
from ava256_tpu_torch.config import load_config
from ava256_tpu_torch.data.dataset import none_collate
from ava256_tpu_torch.data.loader import Uploader
from ava256_tpu_torch.ops import graphs
from ava256_tpu_torch.ops.raymarch_cuda import resolve_device
from ava256_tpu_torch.render import decode
from ava256_tpu_torch.train.loop import build_dataset, to_model_batch
from ava256_tpu_torch.utils import render_img, setup_logging

logger = logging.getLogger("ava256_tpu_torch.cli")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Render cross-id visualizations")
    parser.add_argument("--config", default="configs/config.yaml")
    parser.add_argument("--checkpoint", required=True, help="checkpoint directory")
    parser.add_argument("--driver-index", type=int, default=0)
    parser.add_argument("--driven-index", type=int, default=1)
    parser.add_argument("--num-frames", type=int, default=16)
    parser.add_argument("--stride", type=int, default=1)
    parser.add_argument("--output", default="renders/")
    parser.add_argument("--opts", default=[], nargs="+")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    cfg = load_config(args.config, args.opts)
    setup_logging()
    device = resolve_device(args.device)
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)

    dataset = build_dataset(cfg)
    state = restore(cfg, dataset, args.checkpoint, device)
    upload = Uploader(device)
    driven = dataset.get_neutral_conditioning(args.driven_index)
    driven_tex = torch.from_numpy(driven["neut_avgtex"][None]).to(device)
    driven_verts = torch.from_numpy(driven["neut_verts"][None]).to(device)

    rendered = 0
    for idx in range(0, len(dataset), args.stride):
        if rendered >= args.num_frames:
            break
        item = dataset[idx]
        if item is None or int(item["idindex"]) != args.driver_index:
            continue
        mb = upload.now(to_model_batch(none_collate([item])))
        self_rgb = decode(state.model, mb, mb["neut_avgtex"], mb["neut_verts"])
        cross_rgb = decode(state.model, mb, driven_tex, driven_verts)
        render_img([[mb["image"][0].cpu().numpy(), self_rgb[0].cpu().numpy(),
                     cross_rgb[0].cpu().numpy()]],
                   str(out_dir / f"render_{rendered:04d}.png"))
        rendered += 1
        logger.info("Rendered frame %d (dataset idx %d)", rendered, idx)

    logger.info("Wrote %d frames to %s", rendered, out_dir)
    logger.info("CUDA graphs by module: %s", graphs.report(state.model))
    return rendered


if __name__ == "__main__":
    main()
