# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Ray-sharded rendering, as ``ava256_tpu.parallel.render``: the pixel rows
of one batch are split across the ranks, and only the primitives are shared.
Every rank decodes the whole batch and marches its own slab of rows; the
slabs are gathered and the padding is cropped."""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ava256_tpu_torch.parallel.mesh import all_gather, is_initialized, rank, world_size


def render_rays_sharded(decode_fn: Callable[[Dict[str, Any]], torch.Tensor],
                        batch: Dict[str, Any], tile: int) -> torch.Tensor:
    """decode_fn(batch) -> image [B, H, W, C]; ``batch`` holds "pixelcoords"
    [B, H, W, 2]. Each slab is a whole number of the march's ``tile`` rows,
    so its tiles, and their culled candidates, are those of the whole image;
    the last rank's slab ends at row H, and the outputs are padded to the
    slab height only for the gather. Every tensor of the batch whose leading
    dimensions are (B, H) is cut into the same slab: the model normalizes
    its background's sample coordinates by the rows it is given, so a
    background model needs the whole image's ``bg`` in the batch. With no
    group up: ``decode_fn(batch)``."""
    if not is_initialized():
        return decode_fn(batch)
    b, h = batch["pixelcoords"].shape[:2]
    tile_rows = -(-h // tile)
    rows = -(-tile_rows // world_size()) * tile  # each rank's slab
    lo, hi = min(rank() * rows, h), min((rank() + 1) * rows, h)
    if lo == hi:  # more ranks than tile rows: decode the last row, cropped below
        lo = h - 1
    slab = {k: v[:, lo:hi] if torch.is_tensor(v) and tuple(v.shape[:2]) == (b, h) else v
            for k, v in batch.items()}
    out = decode_fn(slab)
    out = torch.nn.functional.pad(out, (0, 0, 0, 0, 0, rows - out.shape[1]))
    return torch.cat(all_gather(out), dim=1)[:, :h]
