# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Dataset views and collation, the port's own copy of the parts of
``ava256_tpu.data.dataset`` that every dataset uses: ``none_collate`` (drops
failed items), ``CameraSplit`` (the camera hold-out) and
``last_n_camindices``. The capture datasets come with a later slice."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


def none_collate(items: List[Optional[Dict[str, Any]]]) -> Optional[Dict[str, Any]]:
    """Stack dict items into a batch, dropping failed (None) samples."""
    items = [x for x in items if x is not None]
    if not items:
        return None
    out: Dict[str, Any] = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]) or isinstance(
            vals[0], (np.integer, np.floating, int, float, bool)
        ):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals
    return out


class CameraSplit:
    """Camera-level train / held-out split as a view over any dataset that
    has ``item_camindex``.

    The base dataset keeps ALL cameras (so ``get_allcameras``/``camindex``
    and the per-camera colorcal/background tables stay globally indexed);
    the view only restricts which items iterate. ``heldout=False`` yields
    the training split (holdout cameras excluded), ``heldout=True`` the
    evaluation split (holdout cameras only).
    """

    def __init__(self, dataset, holdout_camindices, heldout: bool):
        self.dataset = dataset
        hold = {int(c) for c in holdout_camindices}
        self._indices = [
            i for i in range(len(dataset))
            if (dataset.item_camindex(i) in hold) == heldout
        ]
        if not self._indices:
            raise ValueError(
                f"camera split (heldout={heldout}, cams={sorted(hold)}) is empty"
            )

    def __getattr__(self, name):
        # never forward dunder lookups, and bail before __dict__ is populated,
        # so the split pickles cleanly (as LeanView in data/cond_cache.py)
        if name.startswith("__") or "dataset" not in self.__dict__:
            raise AttributeError(name)
        return getattr(self.dataset, name)

    def __getitem__(self, idx: int):
        return self.dataset[self._indices[int(idx)]]

    def __len__(self) -> int:
        return len(self._indices)


def last_n_camindices(dataset, n: int) -> List[int]:
    """The deterministic holdout set: the last ``n`` camera indices."""
    ncams = len(dataset.get_allcameras())
    if not 0 < n < ncams:
        raise ValueError(f"holdout_cameras={n} must be in (0, {ncams})")
    return list(range(ncams - n, ncams))
