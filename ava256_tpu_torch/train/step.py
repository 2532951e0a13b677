# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The train step, as in ``ava256_tpu.train.step``: forward -> four weighted
losses -> backward -> NaN scrub -> gradient clip -> optimizer update. The
warm-up behaviours (running_avg_scale, the ground-truth geometry, the
residual ramp) are per-call switches.

Under a process group (``ava256_tpu_torch.parallel``) each rank holds its
rows of the global batch: the sampling noise is the global batch's draw,
the gradients are averaged over the ranks before the scrub and the clip (as
GSPMD's psum comes before optax), and the loss and its terms returned are
the global batch's means."""

from __future__ import annotations

from typing import Callable, Dict, FrozenSet, Optional, Tuple

import torch

from ava256_tpu_torch import parallel
from ava256_tpu_torch.data.cond_cache import expand_batch
from ava256_tpu_torch.render import BATCH_MODEL_KEYS
from ava256_tpu_torch.train.losses import compute_losses
from ava256_tpu_torch.train.state import Optimizer, TrainState


def step_generator(device, step: int, seed: int = 0) -> torch.Generator:
    """The sampling generator of one step: a pure function of (seed, step), so
    a resumed run replays the trajectory of an uninterrupted one."""
    return torch.Generator(device=device).manual_seed((int(seed) << 32) + int(step))


def make_train_step(
    model,
    optimizer: Optimizer,
    loss_weights: Dict[str, float],
    vertmean,
    vertstd: float,
    output_set: FrozenSet[str] = frozenset({"primscale"}),
) -> Callable:
    """Returns train_step(state, batch, generator=None, noise=None, *,
    running_avg_scale, use_gt_geo, residuals_weight, cond, mark) ->
    (state, total_loss, loss_terms).

    ``batch`` holds tensors on the model's device. The bottleneck samples
    from ``noise`` when given, else from ``generator``, else from a generator
    seeded with the state's step; under a process group a given ``noise``
    holds this rank's rows. ``cond`` is an optional conditioning-table
    tree on the device (data/cond_cache.py): lean batches are re-expanded by
    gathers there. ``mark(name)`` is called after "forward", "backward" (the
    gradients' all-reduce included) and "optimizer" (for timing)."""
    device = next(model.parameters()).device
    vertmean = torch.as_tensor(vertmean, dtype=torch.float32, device=device)
    output_set = frozenset(output_set) | {"primscale"}

    def train_step(
        state: TrainState,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        running_avg_scale: bool = False,
        use_gt_geo: bool = False,
        residuals_weight: float = 1.0,
        cond=None,
        mark: Optional[Callable[[str], None]] = None,
    ) -> Tuple[TrainState, torch.Tensor, Dict[str, torch.Tensor]]:
        full = expand_batch(batch, cond)
        if generator is None and noise is None:
            generator = step_generator(device, state.step)
        noise_rows = None
        if noise is None and parallel.is_initialized():
            b = full["neut_avgtex"].shape[0]
            noise_rows = (parallel.batch_rows(b).start, b * parallel.world_size())
        optimizer.zero_grad()
        out = model(
            target_neut_avgtex=full["neut_avgtex"],
            target_neut_verts=full["neut_verts"],
            idindex=full.get("idindex"),
            camindex=full.get("camindex"),
            running_avg_scale=running_avg_scale,
            gt_geo=full["verts"] if use_gt_geo else None,
            residuals_weight=residuals_weight,
            output_set=output_set,
            generator=generator,
            noise=noise,
            noise_rows=noise_rows,
            **{k: full[k] for k in BATCH_MODEL_KEYS},
        )
        total, terms = compute_losses(out, full, loss_weights, vertmean, vertstd)
        if mark is not None:
            mark("forward")
        total.backward()
        parallel.all_reduce_gradients(optimizer.params)
        if mark is not None:
            mark("backward")
        means = parallel.all_reduce_mean({"total": total, **terms})
        total, terms = means.pop("total"), means
        optimizer.step(state.step)
        state.step += 1
        if mark is not None:
            mark("optimizer")
        return state, total.detach(), {k: v.detach() for k, v in terms.items()}

    return train_step


def make_eval_step(model, output_set: FrozenSet[str] = frozenset()) -> Callable:
    """Deterministic forward (z = mu), e.g. for progress renders and
    cross-identity evaluation."""

    @torch.no_grad()
    def eval_step(batch, target_neut_avgtex, target_neut_verts):
        return model(
            target_neut_avgtex=target_neut_avgtex,
            target_neut_verts=target_neut_verts,
            idindex=batch.get("idindex"),
            camindex=batch.get("camindex"),
            deterministic=True,
            output_set=output_set,
            **{k: batch[k] for k in BATCH_MODEL_KEYS},
        )

    return eval_step
