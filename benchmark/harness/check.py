"""The numbers that decide ``correct``, each the widest gap between what the
program's timed path produced and what the reference works out from the
same inputs.

Training (the first steps the window's own call took):
- ``loss_gap``: over the steps and the loss terms (and their total),
  |program - reference| / |reference|;
- ``grad_gap``: over the leaves, the gap between the norms of the first
  gradient as the optimizer got it (the program's read back from Adam's
  first moment after one update), over the larger of the reference leaf's
  norm and the median leaf's;
- ``change_gap``: over the same leaves, the gap of each leaf's change
  after the last step, over the leaves whose largest reference gradient
  over the steps is at least a thousandth of the median leaf's (the others
  move under Adam by round-off alone). The widest leaf, not a median: a
  leaf that one side leaves without its gradient after the first step (as
  the grid-sample kernels leave the identity warp's bias, 32,768 entries
  of the 47 million) reads 0.17-0.30 here and nowhere else.

Frames: ``image_gap``, over the sampled frames and both decodes, the sum
of |program - reference| over every pixel channel over the sum of
|reference|. A sum and not the widest channel: where a sample sits on a
box's face or a tile's candidates tie at the cull's cut, the two sides may
take a sample the other leaves out, and one channel of one pixel then
parts by up to 0.5 % of the image's range (one seed in six) while the
image agrees to 1e-6.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

EXCLUDE_BELOW = 1e-3  # of the median leaf's largest gradient norm


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> List[float]:
    med = float(np.median([ref[k] for k in ref])) if ref else 0.0
    return [abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in keep]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    loss = []
    for p, r in zip(prog["losses"], ref["losses"]):
        loss += [abs(p[k] - r[k]) / max(abs(r[k]), 1e-30) for k in r]
    if len(prog["losses"]) != len(ref["losses"]):
        loss.append(math.inf)
    med = float(np.median(list(ref["grad_max"].values())))
    moved = [k for k, g in ref["grad_max"].items() if g >= EXCLUDE_BELOW * med]
    grad = leaf_gaps(prog["grad"], ref["grad"], ref["grad"])
    change = leaf_gaps(prog["change"], ref["change"], moved)
    return {"loss_gap": max(loss),
            "grad_gap": max(grad) if grad else math.nan,
            "change_gap": max(change) if change else math.nan}


def image_numbers(prog: List[np.ndarray], ref: List[np.ndarray]) -> Dict[str, float]:
    if not ref or len(prog) != len(ref):
        return {"image_gap": math.inf}
    diff = sum(float(np.abs(p.astype(np.float64) - r).sum()) for p, r in zip(prog, ref))
    return {"image_gap": diff / max(sum(float(np.abs(r).astype(np.float64).sum())
                                        for r in ref), 1e-30)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    return all(numbers[k] <= limits[k] for k in limits)
