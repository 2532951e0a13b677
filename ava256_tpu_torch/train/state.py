# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Train state, as in ``ava256_tpu.train.state``: optimizer, learning-rate
schedule and checkpoints.

- Adam(2e-4, betas 0.9/0.999, eps 1e-8) with a StepLR-style gamma bump: the
  rate is init_lr for the first ``lr_scheduler_iter`` steps and init_lr *
  gamma after.
- Before the optimizer's core: non-finite gradient entries are zeroed, then
  the global norm is clipped (optax's order: the clip sees the scrubbed
  gradients, the learning rate multiplies after Adam).
- Checkpoints hold the model's parameters and its ``adaptwarps`` buffer, the
  optimizer state and the step, in one ``torch.save`` file written atomically.
  Under a process group rank 0 writes it and every rank restores it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

import torch
from torch import nn

from ava256_tpu_torch import parallel


def step_lr_schedule(init_lr: float, gamma: float, step_size: int) -> Callable[[int], float]:
    """LR = init_lr * gamma^(min(step // step_size, 1))."""

    def schedule(step: int) -> float:
        return init_lr * gamma ** min(int(step) // step_size, 1)

    return schedule


def scrub_nonfinite(grads: List[torch.Tensor]) -> None:
    """Zero NaN/Inf gradient entries, in place."""
    for g in grads:
        torch.nan_to_num_(g, nan=0.0, posinf=0.0, neginf=0.0)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: gradients whose global norm reaches
    ``max_norm`` are scaled to it. Returns the norm before clipping. No host
    synchronization: the scale is a tensor."""
    if not grads:
        return torch.zeros(())
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """scrub -> global-norm clip -> core (adam | adamw | sgd) -> schedule, as
    ``make_optimizer`` of the JAX package chains them. The core is a
    ``torch.optim`` optimizer in its foreach form, given the step's learning
    rate before each update."""

    def __init__(self, params, optim_type: str = "adam", init_lr: float = 2e-4,
                 gamma: float = 1.4, lr_scheduler_iter: int = 10_000, clip: float = 1.0):
        self.params = [p for p in params]
        self.schedule = step_lr_schedule(init_lr, gamma, lr_scheduler_iter)
        self.clip = clip
        if optim_type == "adam":
            self.core = torch.optim.Adam(self.params, lr=init_lr, betas=(0.9, 0.999), eps=1e-8,
                                         foreach=True)
        elif optim_type == "adamw":
            self.core = torch.optim.AdamW(self.params, lr=init_lr, betas=(0.9, 0.999), eps=1e-8,
                                          weight_decay=1e-4, foreach=True)
        elif optim_type == "sgd":
            self.core = torch.optim.SGD(self.params, lr=init_lr, momentum=0.9, foreach=True)
        else:
            raise ValueError(f"Unsupported optimizer: {optim_type}")

    def zero_grad(self) -> None:
        self.core.zero_grad(set_to_none=True)

    def step(self, step: int) -> torch.Tensor:
        """One update from the parameters' ``.grad``; ``step`` is the number of
        updates made so far. Returns the gradients' global norm before the clip."""
        grads = [p.grad for p in self.params if p.grad is not None]
        scrub_nonfinite(grads)
        norm = clip_by_global_norm(grads, self.clip)
        for group in self.core.param_groups:
            group["lr"] = self.schedule(step)
        self.core.step()
        return norm

    def state_dict(self):
        return self.core.state_dict()

    def load_state_dict(self, sd) -> None:
        self.core.load_state_dict(sd)


def make_optimizer(model: nn.Module, optim_type: str = "adam", init_lr: float = 2e-4,
                   gamma: float = 1.4, lr_scheduler_iter: int = 10_000,
                   clip: float = 1.0) -> Optimizer:
    return Optimizer(model.parameters(), optim_type, init_lr, gamma, lr_scheduler_iter, clip)


@dataclass
class TrainState:
    """The model (parameters and the ``adaptwarps`` buffer), the optimizer
    state and the number of steps taken. A train step updates it in place."""
    model: nn.Module
    optimizer: Optimizer
    step: int = 0


def _ckpt_path(ckpt_dir, step: int) -> Path:
    return Path(ckpt_dir).absolute() / f"step_{step:08d}.pt"


def save_checkpoint(ckpt_dir, state: TrainState, step: Optional[int] = None) -> Path:
    """Write ``step_XXXXXXXX.pt`` under ckpt_dir: to a temporary name first,
    then renamed, so a reader never sees half a file. Under a process group
    only rank 0 writes (the ranks hold the same state), and every rank waits
    at a barrier until the file is there."""
    step = int(state.step) if step is None else step
    path = _ckpt_path(ckpt_dir, step)
    if parallel.rank() == 0:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(), "step": int(state.step)}, tmp)
        os.replace(tmp, path)
    parallel.barrier()
    return path


def latest_checkpoint_step(ckpt_dir) -> Optional[int]:
    path = Path(ckpt_dir)
    if not path.is_dir():
        return None
    steps = [int(p.stem.split("_")[1]) for p in path.glob("step_*.pt")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir, state: TrainState, step: Optional[int] = None) -> TrainState:
    """Load the checkpoint of ``step`` (default: the latest) into ``state``'s
    model and optimizer, on the device the model lies on."""
    if step is None:
        step = latest_checkpoint_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    device = next(state.model.parameters()).device
    ckpt = torch.load(_ckpt_path(ckpt_dir, step), map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return state
