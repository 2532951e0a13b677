# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Dump the identity conditioning of every subject, as
``generate_id_cond.py``: runs the identity encoder on each subject's neutral
data and pickles its output (``z_geo`` / ``z_tex`` codes and the ``b_geo`` /
``b_tex`` bias pyramids, numpy arrays in the JAX package's NHWC layout, so a
file from either package loads in the other) as ``{name}.pkl``. numpy has no
bfloat16: a bfloat16 model's codes are written as float32, which holds them
exactly.

    python -m ava256_tpu_torch.cli.generate_id_cond \\
        --config configs/config-synthetic-flagship.yaml --checkpoint RUN/checkpoints \\
        --output id_conds/ --opts assets=DIR
"""

from __future__ import annotations

import argparse
import logging
import pickle
from pathlib import Path

import torch

from ava256_tpu_torch.cli.common import add_device_arg, restore
from ava256_tpu_torch.config import load_config
from ava256_tpu_torch.ops.raymarch_cuda import resolve_device
from ava256_tpu_torch.train.loop import build_dataset
from ava256_tpu_torch.utils import setup_logging

logger = logging.getLogger("ava256_tpu_torch.cli")


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if tree.dtype == torch.bfloat16:
        tree = tree.float()
    return tree.detach().cpu().numpy()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/config.yaml")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--output", default="id_conds/")
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
    names = []
    for i in range(len(dataset.identities)):
        cond = dataset.get_neutral_conditioning(i)
        with torch.inference_mode():
            id_cond = state.model.identity_encoder(
                torch.from_numpy(cond["neut_verts"][None]).to(device),
                torch.from_numpy(cond["neut_avgtex"][None]).to(device))
        ident = dataset.identities[i]
        name = ident.folder_name() if hasattr(ident, "folder_name") else f"id{i:03d}"
        with open(out_dir / f"{name}.pkl", "wb") as f:
            pickle.dump(_to_numpy(id_cond), f)
        names.append(name)
        logger.info("Wrote id_cond for %s", name)
    return names


if __name__ == "__main__":
    main()
