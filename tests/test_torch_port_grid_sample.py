# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""``ava256_tpu_torch.ops.grid_sample.GridSample``, the autograd function in
front of the grid-sample kernels (``csrc/grid_sample.cu``), on its CPU route:

- it equals ``F.grid_sample`` and that op's own backward bit for bit (its
  plain version);
- it is held to the JAX package's ``ava256_tpu.ops.grid_sample`` (both of its
  forms) at 1e-5 on the outputs and at cosine > 0.9999 on the gradients
  (jax.vjp), with samples beyond the border and on half-pixel positions, at
  the shapes of both call sites: a level of the identity encoder's bias
  pyramid sampled on a warp grid shared by the batch, and the geometry
  decoder's vertex sampling ([N, V, 1, 2]);
- it refuses bfloat16 and float64 with an error that says so.

The kernels themselves run on the card: ``tests/test_torch_port_cuda.py``
and ``chip_smoke.py`` ``[grid-sample]``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ava256_tpu.ops import grid_sample as jgs
from ava256_tpu_torch.ops import grid_sample as gs

torch.set_num_threads(min(4, torch.get_num_threads()))
OUT_TOL, GRAD_COS = 1e-5, 0.9999


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / np.sqrt((a @ a) * (b @ b)))


def _identity_level(rng):
    """A pyramid level [2, 16, 16, 32] and a warp grid shared by the batch:
    an identity grid plus a small bias, as the identity encoder makes it."""
    img = rng.randn(2, 16, 16, 32).astype(np.float32)
    xs = np.linspace(-1.0, 1.0, 16, dtype=np.float32)
    xg, yg = np.meshgrid(xs, xs)
    grid = np.stack([xg, yg], -1)[None] + 0.05 * rng.randn(1, 16, 16, 2).astype(np.float32)
    return img, np.repeat(grid, 2, axis=0).astype(np.float32)


def _vertex_sampling(rng):
    """A geometry map [2, 32, 32, 3] sampled at 50 vertices [2, 50, 1, 2]."""
    img = rng.randn(2, 32, 32, 3).astype(np.float32)
    return img, rng.uniform(-1.0, 1.0, (2, 50, 1, 2)).astype(np.float32)


def _border(rng):
    """Samples beyond the border (up to 1.3) and exactly on half-pixel
    positions (source coordinates k + 0.5 with align_corners False)."""
    img = rng.randn(2, 9, 11, 4).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 6, 7, 2)).astype(np.float32)
    # x = (2 * (k + 0.5) + 1) / W - 1 puts the source at k + 0.5
    kx = rng.randint(-2, 12, size=(2, 3, 7))
    ky = rng.randint(-2, 10, size=(2, 3, 7))
    grid[:, :3, :, 0] = (2.0 * (kx + 0.5) + 1.0) / 11 - 1.0
    grid[:, :3, :, 1] = (2.0 * (ky + 0.5) + 1.0) / 9 - 1.0
    return img, grid


CASES = {"identity_level": _identity_level, "vertex_sampling": _vertex_sampling,
         "border_and_half_pixel": _border}


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_cpu_route_is_f_grid_sample(case):
    """The CPU route is the plain version: F.grid_sample and its backward,
    bit for bit, gradients to the image and the grid."""
    img, grid = CASES[case](np.random.RandomState(1))
    gout = np.random.RandomState(2).randn(img.shape[0], *grid.shape[1:3],
                                          img.shape[3]).astype(np.float32)
    outs = []
    for fn in ("function", "library"):
        i = torch.from_numpy(img).requires_grad_()
        g = torch.from_numpy(grid).requires_grad_()
        if fn == "function":
            out = gs.GridSample.apply(i, g, False)
        else:
            out = F.grid_sample(i.permute(0, 3, 1, 2), g, mode="bilinear", padding_mode="zeros",
                                align_corners=False).permute(0, 2, 3, 1)
        out.backward(torch.from_numpy(gout))
        outs.append((out.detach(), i.grad, g.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_function_matches_jax(case, packed):
    img, grid = CASES[case](np.random.RandomState(3))
    gout = np.random.RandomState(4).randn(img.shape[0], *grid.shape[1:3],
                                          img.shape[3]).astype(np.float32)
    ref, vjp = jax.vjp(lambda a, b: jgs.grid_sample_2d(a, b, align_corners=False,
                                                       packed=packed),
                       jnp.asarray(img), jnp.asarray(grid))
    ref_img, ref_grid = vjp(jnp.asarray(gout))
    i = torch.from_numpy(img).requires_grad_()
    g = torch.from_numpy(grid).requires_grad_()
    out = gs.grid_sample_2d(i, g, align_corners=False)
    out.backward(torch.from_numpy(gout))
    ref = np.asarray(ref)
    assert np.abs(out.detach().numpy() - ref).max() <= OUT_TOL * (1.0 + np.abs(ref).max())
    assert _cos(i.grad.numpy(), ref_img) > GRAD_COS
    assert _cos(g.grad.numpy(), ref_grid) > GRAD_COS


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_function_refuses_other_dtypes(dtype):
    img = torch.zeros((1, 4, 4, 2), dtype=dtype)
    grid = torch.zeros((1, 3, 3, 2), dtype=dtype)
    with pytest.raises(ValueError, match="float32"):
        gs.GridSample.apply(img, grid, False)
    with pytest.raises(ValueError, match="float32"):
        gs.grid_sample_2d(img, grid)  # the promoted dtype is still not float32


def test_bfloat16_image_on_float32_grid_is_promoted():
    """What the bfloat16 model does: a bfloat16 pyramid level on the float32
    warp grid samples in float32, equal to sampling its float32 values."""
    img, grid = _identity_level(np.random.RandomState(5))
    low = torch.from_numpy(img).to(torch.bfloat16)
    out = gs.grid_sample_2d(low, torch.from_numpy(grid))
    assert out.dtype == torch.float32
    assert torch.equal(out, gs.grid_sample_plain(low.float(), torch.from_numpy(grid)))
