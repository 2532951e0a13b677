# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Process groups and data parallelism over ``torch.distributed``, the
counterpart of ``ava256_tpu.parallel.mesh``.

The JAX package trains data-parallel as one SPMD program over a ``data``
mesh: the batch is sharded along it, the parameters are replicated, and XLA
sums the gradients before the optimizer. Here each device has a process of
its own, as ``torchrun`` launches them (one per GPU, the reference's DDP):

- ``init_from_env`` joins the group that the launcher's environment
  describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``): NCCL on CUDA devices, gloo on the CPU. Each rank takes
  ``cuda:LOCAL_RANK``.
- ``batch_rows(b)``: rank r holds rows [r*b, (r+1)*b) of the global batch,
  the order in which ``shard_batch`` assembles it from process-local data.
- ``all_reduce_gradients``: the mean of every parameter's gradient over the
  ranks, in one collective on one flat buffer.
- ``all_reduce_mean``, ``all_reduce_max_``, ``all_ranks``: the loss terms
  for the log, the max of a statistic over the global batch, and a flag
  every rank must agree on.

Every rank builds the model from the same seed (and restores the same
checkpoint), so the parameters start replicated, as ``replicated_sharding``
keeps them. With no group up, every function is the single-process one:
rank 0 of 1, and no collective. ``COUNTS`` counts the collectives each
function has launched.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
COUNTS: Dict[str, int] = dict.fromkeys(
    ("all_reduce_gradients", "all_reduce_mean", "all_reduce_max", "all_ranks", "barrier",
     "all_gather"), 0)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def backend() -> Optional[str]:
    return dist.get_backend() if is_initialized() else None


def init_from_env(device) -> torch.device:
    """Join the process group of the launcher's environment (once) and return
    this rank's device: ``cuda:LOCAL_RANK`` for a CUDA ``device``, else
    ``device``. Raises when the environment names no group."""
    missing = [v for v in LAUNCH_VARS if v not in os.environ]
    if missing:
        raise RuntimeError(
            f"mesh.multihost: true needs the environment a launcher sets ({', '.join(missing)} "
            "unset): start one process per device with torchrun, e.g. `torchrun "
            "--nproc_per_node N -m ava256_tpu_torch.cli.train --config ... mesh.multihost=true`")
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    if not is_initialized():
        if device.type == "cuda":
            dist.init_process_group("nccl", init_method="env://", device_id=device)
        else:
            dist.init_process_group("gloo", init_method="env://")
    return device


def destroy() -> None:
    if is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if is_initialized():
        COUNTS["barrier"] += 1
        dist.barrier()


def batch_rows(b: int) -> slice:
    """The rows of the global batch that this rank holds, for a per-rank batch b."""
    r = rank()
    return slice(r * b, (r + 1) * b)


def all_reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace every parameter's gradient by its mean over the ranks: one
    all-reduce of one flat buffer that holds every gradient (zeros where a
    rank has none) and a flag per parameter. A parameter that no rank gave a
    gradient keeps none, as in a single process; the others' gradients
    become views of the buffer."""
    if not is_initialized():
        return
    params = list(params)
    if not params:
        return
    ref = params[0]
    has = torch.tensor([p.grad is not None for p in params], dtype=ref.dtype, device=ref.device)
    flat = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
                      for p in params] + [has])
    COUNTS["all_reduce_gradients"] += 1
    dist.all_reduce(flat)
    flat.div_(world_size())
    views = torch.split(flat, [p.numel() for p in params] + [len(params)])
    for p, v, any_grad in zip(params, views, views[-1].tolist()):
        p.grad = v.view_as(p) if any_grad > 0 else None


def all_reduce_mean(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalars -> their means over the ranks, in one collective."""
    if not is_initialized() or not tensors:
        return tensors
    flat = torch.stack([t.detach().reshape(()) for t in tensors.values()])
    COUNTS["all_reduce_mean"] += 1
    dist.all_reduce(flat)
    flat.div_(world_size())
    return dict(zip(tensors, flat.unbind()))


def all_reduce_max_(t: torch.Tensor) -> torch.Tensor:
    """t <- its elementwise max over the ranks, in place."""
    if is_initialized():
        COUNTS["all_reduce_max"] += 1
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def all_ranks(flag: bool, device) -> bool:
    """True when ``flag`` holds on every rank."""
    if not is_initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    COUNTS["all_ranks"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def all_gather(t: torch.Tensor) -> list:
    """Every rank's ``t`` (the same shape on each), in rank order."""
    if not is_initialized():
        return [t]
    out = [torch.empty_like(t) for _ in range(world_size())]
    COUNTS["all_gather"] += 1
    dist.all_gather(out, t.contiguous())
    return out
