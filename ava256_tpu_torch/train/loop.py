# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The training loop, as the JAX package's ``train.py`` runs it on one device:

    python -m ava256_tpu_torch.train.loop --out run-flagship/ --steps 200

Batches are drawn straight from the synthetic dataset (shuffled by a seeded
generator, one order per epoch, so a resumed run continues the same order);
the first ``warmup_iters`` steps run with the warm-up switches
(running_avg_scale, ground-truth geometry, residuals off); every step logs
its loss terms and the effective learning rate; checkpoints are written at
the reference cadence (every 2,000 steps under 10,000, then every 20,000, or
``checkpoint_every``) and at the end, and a run that finds checkpoints in its
output directory resumes from the latest.

The settings default to the flagship configuration (``flagship.FLAGSHIP``);
``run`` takes any dict of that layout. Runs on the card unless ``device`` is
"cpu".
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ava256_tpu_torch.data.synthetic import SyntheticDataset, none_collate, synthetic_uvdata
from ava256_tpu_torch.factory import get_autoencoder
from ava256_tpu_torch.flagship import FLAGSHIP
from ava256_tpu_torch.ops.raymarch_cuda import resolve_device
from ava256_tpu_torch.render import BATCH_MODEL_KEYS
from ava256_tpu_torch.train.state import (
    TrainState, latest_checkpoint_step, make_optimizer, restore_checkpoint, save_checkpoint)
from ava256_tpu_torch.train.step import make_train_step, step_generator

logger = logging.getLogger("ava256_tpu_torch.train")

_BATCH_KEYS = set(BATCH_MODEL_KEYS) | {"idindex", "camindex", "image"}


def build(cfg: Dict[str, Any], device="cuda", seed: int = 0):
    """(dataset, state, train_step) of a configuration."""
    ds = SyntheticDataset(nident=cfg["nident"], ncams=cfg["ncams"], nframes=cfg["nframes"],
                          height=cfg["height"], width=cfg["width"], texsize=cfg["texsize"])
    model = get_autoencoder(
        synthetic_uvdata(cfg["texsize"]), ds.vertmean, ds.vertstd, ncams=cfg["ncams"],
        nident=cfg["nident"], volradius=cfg["volradius"], nprims=cfg["nprims"],
        primsize=(cfg["primsize"],) * 3, colorcal=cfg["colorcal"], bgmodel=cfg["bgmodel"],
        raymarch_options={"tile": cfg["tile"], "max_hit": cfg["max_hit"],
                          **cfg.get("raymarch_options", {})},
        device=device, seed=seed)
    optimizer = make_optimizer(model, cfg["optimizer"], cfg["lr"], cfg["gamma"],
                               cfg["lr_scheduler_iter"], cfg["clip"])
    train_step = make_train_step(model, optimizer, dict(cfg["losses"]), ds.vertmean, ds.vertstd,
                                 output_set=frozenset(cfg["output_set"]))
    return ds, TrainState(model, optimizer, 0), train_step


def to_model_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()
            if k in _BATCH_KEYS}


def batches(ds, batchsize: int, start_step: int, seed: int = 0) -> Iterator[Dict[str, Any]]:
    """Collated batches in a seeded shuffled order, one permutation per epoch,
    starting at the position ``start_step`` batches into the run. Positions
    whose items all failed to load are passed over; a whole epoch of them in a
    row raises."""
    per_epoch = len(ds) // batchsize
    step, missed = start_step, 0
    while True:
        epoch, pos = divmod(step, per_epoch)
        order = np.random.RandomState(seed + epoch).permutation(len(ds))
        idx: List[int] = order[pos * batchsize:(pos + 1) * batchsize].tolist()
        batch = none_collate([ds[i] for i in idx])
        step += 1
        if batch is not None:
            missed = 0
            yield batch
        elif (missed := missed + 1) >= per_epoch:
            raise RuntimeError(f"no item of the dataset loaded in {missed} batches in a row")


def checkpoint_cadence(step: int, checkpoint_every: Optional[int]) -> int:
    """Steps between mid-run checkpoints at ``step``; 0 or less: none."""
    if checkpoint_every is None:
        return 2_000 if step < 10_000 else 20_000
    return int(checkpoint_every)


def run(cfg: Dict[str, Any] = FLAGSHIP, out: str = "run/", steps: Optional[int] = None,
        device="cuda", seed: int = 0, checkpoint_every: Optional[int] = None,
        checkpoint: str = "") -> TrainState:
    """Train ``steps`` steps in all (default: cfg["maxiter"]), resuming from
    ``checkpoint`` or from the latest checkpoint under ``out``. Returns the
    final state."""
    device = resolve_device(device)
    maxiter = int(cfg["maxiter"] if steps is None else steps)
    t0 = time.time()
    ds, state, train_step = build(cfg, device, seed)
    nparams = sum(p.numel() for p in state.model.parameters())
    logger.info("Dataset and model ready (%.1f s): %d items, %s params", time.time() - t0,
                len(ds), f"{nparams:_}")

    ckpt_dir = Path(out) / "checkpoints"
    if checkpoint:
        state = restore_checkpoint(checkpoint, state)
        logger.info("Restored checkpoint at step %d", state.step)
    elif latest_checkpoint_step(ckpt_dir) is not None:
        state = restore_checkpoint(ckpt_dir, state)
        logger.info("Resumed from %s at step %d", ckpt_dir, state.step)

    warmup = int(cfg.get("warmup_iters", 100))
    iter_end = time.time()
    for batch in batches(ds, cfg["batch"], state.step, seed):
        iternum = state.step
        if iternum >= maxiter:
            break
        iter_start = iter_end
        in_warmup = iternum < warmup
        state, loss, terms = train_step(
            state, to_model_batch(batch, device),
            generator=step_generator(device, iternum, seed),
            running_avg_scale=in_warmup, use_gt_geo=in_warmup,
            residuals_weight=0.0 if in_warmup else 1.0)
        loss = float(loss)  # waits for the step

        cadence = checkpoint_cadence(iternum, checkpoint_every)
        if cadence > 0 and iternum % cadence == 0 and iternum > 0:
            # the state after step iternum, named by its step count
            save_checkpoint(ckpt_dir, state)
            logger.info("Saved checkpoint at step %d", state.step)

        iter_end = time.time()
        logger.info("Iteration %d loss = %.4f, %s lr = %.2e, time: %.3f s", iternum, loss,
                    ", ".join(f"{k} = {float(v):.4f}" for k, v in terms.items()),
                    state.optimizer.schedule(iternum), iter_end - iter_start)
    logger.info("Stopping at max iter %d", state.step)
    save_checkpoint(ckpt_dir, state)
    logger.info("Final checkpoint saved at step %d", state.step)
    return state


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Train the flagship avatar autoencoder")
    parser.add_argument("--out", default="run-flagship/", help="output directory")
    parser.add_argument("--steps", type=int, default=None, help="stop at this step count")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint-every", type=int, default=None)
    parser.add_argument("--checkpoint", default="", help="checkpoint directory to start from")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    run(FLAGSHIP, out=args.out, steps=args.steps, device=args.device, seed=args.seed,
        checkpoint_every=args.checkpoint_every, checkpoint=args.checkpoint)


if __name__ == "__main__":
    main()
