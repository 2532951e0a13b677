"""The model's weights, made by the benchmark from the seed: one draw on
the device for every layer weight (Uniform(-bound, bound) with the layer's
Xavier bound), each weight-norm gain at its weight's Frobenius norm, biases
and the slabs' biases zero, the colour calibration at the identity. The
names and shapes are the reference model's; the program loads the same
tensors."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.model import Autoencoder, parameter_bounds, weight_norm_gains


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each use of the run's seed."""
    return (int(seed) * 1_000_003 + stream * 7_919) % (2 ** 63 - 1)


def make(dims: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        shapes = Autoencoder(dims)
    bounds = parameter_bounds(shapes)
    gains = set(weight_norm_gains(shapes))
    sd = {k: torch.zeros(v.shape, device=device) for k, v in shapes.state_dict().items()}
    names = sorted(bounds)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    flat = torch.rand(sum(sd[n].numel() for n in names), generator=gen, device=device)
    at = 0
    for n in names:
        k = sd[n].numel()
        sd[n] = ((flat[at:at + k] * 2.0 - 1.0) * bounds[n]).reshape(sd[n].shape)
        at += k
        if n[: -len("weight")] + "g" in gains:
            g = n[: -len("weight")] + "g"
            sd[g] = torch.sqrt(torch.sum(sd[n] ** 2)) * torch.ones_like(sd[g])
    sd["colorcal.wcam"] = torch.ones_like(sd["colorcal.wcam"])
    return sd
