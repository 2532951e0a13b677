# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Device-resident conditioning tables, as in ``ava256_tpu.data.cond_cache``:
per-identity, per-camera and constant batch fields are kept on the device and
gathered by index inside the step, instead of being shipped from the host
every iteration (at the flagship shape two 1024^2 fp32 textures per element
are about 100 MB per step).

Tables layout::

    {"id":    {field: [nident, ...]},   # gathered by batch["idindex"]
     "cam":   {field: [ncams, ...]},    # gathered by batch["camindex"]
     "const": {field: [...]}}           # broadcast over the batch

``LeanView`` strips the cached fields from a dataset's items, and
``expand_batch`` re-materializes them on the device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Set

import numpy as np
import torch

Tables = Dict[str, Dict[str, Any]]

_INDEX_OF = {"id": "idindex", "cam": "camindex"}


def cached_field_names(tables: Optional[Tables]) -> Set[str]:
    """All batch field names a table set covers."""
    if not tables:
        return set()
    names: Set[str] = set()
    for group in tables.values():
        names |= set(group)
    return names


def table_nbytes(tables: Optional[Tables]) -> int:
    if not tables:
        return 0
    return sum(int(np.prod(v.shape)) * (v.element_size() if isinstance(v, torch.Tensor)
                                        else np.asarray(v).itemsize)
               for group in tables.values() for v in group.values())


def tables_to_device(tables: Tables, device) -> Tables:
    """The tables as tensors on ``device`` (uploaded once)."""
    return {g: {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in group.items()}
            for g, group in tables.items()}


def expand_batch(batch: Dict[str, Any], tables: Optional[Tables]) -> Dict[str, Any]:
    """Re-materialize cached fields into ``batch`` by gathers on the batch's
    device. id/cam tables are gathered by the batch's index fields, const
    tables broadcast over the batch. Fields already in the batch are left
    untouched, so a full batch passes through unchanged."""
    if not tables:
        return batch
    out = dict(batch)
    nbatch = None
    for group_name in ("id", "cam"):
        group = tables.get(group_name)
        if not group:
            continue
        idx = batch[_INDEX_OF[group_name]].long()
        nbatch = idx.shape[0]
        for k, v in group.items():
            if k not in out:
                out[k] = torch.index_select(torch.as_tensor(v, device=idx.device), 0, idx)
    for k, v in tables.get("const", {}).items():
        if k in out:
            continue
        if nbatch is None:
            nbatch = next(iter(batch.values())).shape[0]
        v = torch.as_tensor(v, device=next(iter(batch.values())).device)
        out[k] = v[None].expand((nbatch,) + tuple(v.shape))
    return out


def expand_batch_host(batch: Dict[str, Any], tables: Optional[Tables]) -> Dict[str, Any]:
    """Numpy twin of ``expand_batch`` for host-side consumers (progress
    renders, visualization) fed a lean batch."""
    if not tables:
        return batch
    out = {k: np.asarray(v) for k, v in batch.items()}
    nbatch = None
    for group_name in ("id", "cam"):
        group = tables.get(group_name)
        if not group:
            continue
        idx = out[_INDEX_OF[group_name]]
        nbatch = idx.shape[0]
        for k, v in group.items():
            if k not in out:
                out[k] = np.asarray(v)[idx]
    for k, v in tables.get("const", {}).items():
        if k in out:
            continue
        v = np.asarray(v)
        if nbatch is None:
            nbatch = next(iter(out.values())).shape[0]
        out[k] = np.broadcast_to(v[None], (nbatch,) + v.shape)
    return out


class LeanView:
    """Dataset view that drops table-covered fields from items, so loader
    workers never materialize the big constant arrays. Attribute access
    forwards to the base dataset."""

    def __init__(self, dataset, drop_fields: Set[str]):
        self.dataset = dataset
        self.drop_fields = set(drop_fields)

    def __getattr__(self, name):
        # never forward dunder lookups, and bail before __dict__ is populated:
        # pickle probes __setstate__ on a bare instance during unpickling
        if name.startswith("__") or "dataset" not in self.__dict__:
            raise AttributeError(name)
        return getattr(self.dataset, name)

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int):
        item = self.dataset[idx]
        if item is None:
            return None
        return {k: v for k, v in item.items() if k not in self.drop_fields}
