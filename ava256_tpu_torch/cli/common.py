# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""What the inference entry points share: the ``--device`` flag and a
trained model restored from a checkpoint directory."""

from __future__ import annotations

import argparse
import logging

from ava256_tpu_torch.train.loop import build_model, load_uvdata
from ava256_tpu_torch.train.state import TrainState, make_optimizer, restore_checkpoint

logger = logging.getLogger("ava256_tpu_torch.cli")


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda by default; cpu runs the plain "
                             "PyTorch versions of the kernels)")


def restore(cfg, dataset, checkpoint: str, device) -> TrainState:
    """The configured model with the latest checkpoint under ``checkpoint``
    (a directory of ``train.state.save_checkpoint`` files), in eval mode."""
    model = build_model(cfg, dataset, load_uvdata(cfg), device)
    state = restore_checkpoint(checkpoint, TrainState(model, make_optimizer(model), 0))
    model.eval()
    logger.info("Restored checkpoint at step %d", state.step)
    return state
