# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Weights of the JAX package -> this port's ``state_dict``.

The input is a flax variable tree ``{"params": ..., "stats": ...}`` given as
nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, vars)``
gives one). The port names its modules after the flax paths, so
``params/decoder_assembler/geodec/t0/weight`` becomes
``decoder_assembler.geodec.t0.weight`` and ``stats/.../adaptwarps`` the
buffer of the same path. Layouts change by the owning module's type:

- convs: HWIO -> OIHW;
- transposed convs: the JAX kernel is a correlation over the stride-dilated
  input, so it is flipped in both spatial axes and becomes [in, out, kh, kw];
- dense layers: [in, out] -> [out, in].

``load_train_state`` carries a whole JAX ``TrainState.as_dict()`` across:
parameters, the ``adaptwarps`` statistic, the optimizer's moments (optax's
Adam ``mu`` / ``nu`` / ``count``, or SGD's ``trace``) in the same layouts,
and the step. Reading an Orbax checkpoint into such a tree is the caller's
job, with the JAX package: this module imports neither.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from ava256_tpu_torch.ops.layers import Conv2d, Conv2dWN, ConvTranspose2dWN, Linear, LinearWN


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _to_torch_layout(module: nn.Module, leaf: str, x: np.ndarray) -> np.ndarray:
    if leaf != "weight":
        return x
    if isinstance(module, (Conv2dWN, Conv2d)):
        return x.transpose(3, 2, 0, 1)
    if isinstance(module, ConvTranspose2dWN):
        return x[::-1, ::-1].transpose(2, 3, 0, 1)
    if isinstance(module, (LinearWN, Linear)):
        return x.T
    return x


def flax_to_state_dict(tree: Mapping[str, Any], model: nn.Module) -> Dict[str, torch.Tensor]:
    """Map a flax ``{"params", "stats"}`` tree onto ``model``'s state_dict.
    Raises if a tensor of the model has no counterpart, a leaf of the tree is
    left over, or a shape disagrees."""
    flat = _flatten(tree)
    used = set()
    out: Dict[str, torch.Tensor] = {}
    for key, ref in model.state_dict().items():
        path = key.replace(".", "/")
        src = next((f"{col}/{path}" for col in ("params", "stats") if f"{col}/{path}" in flat),
                   None)
        if src is None:
            raise KeyError(f"no flax leaf for {key}")
        owner, _, leaf = key.rpartition(".")
        x = _to_torch_layout(model.get_submodule(owner), leaf, flat[src])
        if tuple(x.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: flax {flat[src].shape} -> {x.shape}, model "
                             f"{tuple(ref.shape)}")
        out[key] = torch.tensor(np.ascontiguousarray(x), dtype=ref.dtype)
        used.add(src)
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"flax leaves without a model tensor: {extra[:8]}")
    return out


def load_flax(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Load a flax tree into ``model`` in place (on the model's device)."""
    model.load_state_dict(flax_to_state_dict(tree, model))
    return model


def _find_opt_state(opt_state: Any, fields) -> Any:
    """The element of an optax chain state (nested tuples of namedtuples, or
    mappings) that holds ``fields``."""
    def get(node, f):
        return node.get(f) if isinstance(node, Mapping) else getattr(node, f, None)

    if all(get(opt_state, f) is not None for f in fields):
        return {f: get(opt_state, f) for f in fields}
    children = (opt_state.values() if isinstance(opt_state, Mapping)
                else opt_state if isinstance(opt_state, (tuple, list)) else ())
    for child in children:
        found = _find_opt_state(child, fields)
        if found is not None:
            return found
    return None


def load_train_state(state, tree: Mapping[str, Any]):
    """Load a JAX ``TrainState.as_dict()`` (numpy leaves: ``params``,
    ``stats``, ``opt_state``, ``step``) into the port's
    ``train.state.TrainState`` in place: model, optimizer moments and step."""
    model, core = state.model, state.optimizer.core
    load_flax(model, {"params": tree["params"], "stats": tree.get("stats", {})})
    names = {id(p): n for n, p in model.named_parameters()}

    def moments(params_like):
        sd = flax_to_state_dict({"params": params_like, "stats": tree.get("stats", {})}, model)
        return {n: sd[n] for n in names.values()}

    adam = _find_opt_state(tree["opt_state"], ("mu", "nu", "count"))
    trace = _find_opt_state(tree["opt_state"], ("trace",))
    if isinstance(core, (torch.optim.Adam, torch.optim.AdamW)):
        if adam is None:
            raise KeyError("no Adam state (mu, nu, count) in the optax tree")
        mu, nu = moments(adam["mu"]), moments(adam["nu"])
        count = float(np.asarray(adam["count"]))
        for p in state.optimizer.params:
            n = names[id(p)]
            core.state[p] = {"step": torch.tensor(count),
                             "exp_avg": mu[n].to(p.device), "exp_avg_sq": nu[n].to(p.device)}
    else:
        if trace is None:
            raise KeyError("no momentum trace in the optax tree")
        tr = moments(trace["trace"])
        for p in state.optimizer.params:
            core.state[p] = {"momentum_buffer": tr[names[id(p)]].to(p.device)}
    state.step = int(np.asarray(tree["step"]))
    return state
