# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""What the graph tests on the CPU (``test_torch_port_graphs.py``) and on the
card (``test_torch_port_cuda.py``) share. Imports nothing of ``tests``, so
the card's file can import it by its own name."""

import torch
from torch.utils import _pytree as pytree

from ava256_tpu_torch import bench
from ava256_tpu_torch.render import BATCH_MODEL_KEYS

GRAPHED = ("identity_encoder", "expression_encoder", "decoder_assembler")
# (captures, replays) after three frames, self- then cross-driven: the other
# identity's neutral texture is a transposed view, as the dataset gives it,
# so the identity encoder and the assembler it feeds see two signatures
FRAMES_3 = {"identity_encoder": (2, 4), "expression_encoder": (1, 5),
            "decoder_assembler": (2, 4)}


def warm_scene(device, **kw):
    """The model with its primitives scaled by one warm-up forward (as the
    render benchmark's set-up does), a batch, and another identity's
    neutral texture and vertices."""
    torch.manual_seed(0)
    model, mb, ds = bench.build(device=device, **kw)
    with torch.inference_mode():
        model(target_neut_avgtex=mb["neut_avgtex"], target_neut_verts=mb["neut_verts"],
              idindex=mb["idindex"], camindex=mb["camindex"], running_avg_scale=True,
              gt_geo=mb["verts"], residuals_weight=0.0, deterministic=True,
              **{k: mb[k] for k in BATCH_MODEL_KEYS})
    driven = ds.get_neutral_conditioning(1)
    return (model, mb, torch.from_numpy(driven["neut_avgtex"][None]).to(device),
            torch.from_numpy(driven["neut_verts"][None]).to(device))


def tensors(x) -> list:
    """The tensors of a nest of lists, tuples and dicts, in order."""
    return [t for t in pytree.tree_leaves(x) if isinstance(t, torch.Tensor)]
