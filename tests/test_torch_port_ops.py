# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The port's ops (ava256_tpu_torch.ops) against the JAX package on the CPU.

Inputs come from a numpy seed; layer weights are the flax layer's own init,
moved by ``ava256_tpu_torch.convert``. Tolerance for every op:
max|d| <= 1e-5 max|ref| + 1e-6 (fp32 on both sides; only the summation
order of convs and matmuls differs).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ava256_tpu_torch import ops
from ava256_tpu_torch.convert import flax_to_state_dict
from ava256_tpu_torch.ops.layers import nchw_to_nhwc, nhwc_to_nchw
from ava256_tpu_torch.ops.raymarch_ref import grid_sample_3d

from tests import _torch_port_threads  # noqa: F401
from ava256_tpu import ops as jops
from ava256_tpu.ops.layers import Conv2d as JConv2d, ConvSeq as JConvSeq, Linear as JLinear
from ava256_tpu.ops.raymarch_ref import grid_sample_3d as jax_grid_sample_3d


def _close(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    lim = 1e-5 * np.abs(ref).max() + 1e-6
    assert err <= lim, f"{what}: max|d| {err:.3g} > {lim:.3g}"


def _t(x):
    return torch.from_numpy(np.array(x))


def _layer_pair(jlayer, tlayer, x, seed=0):
    """Init the flax layer, load its weights into the torch layer, return
    both outputs on x (NHWC for convs)."""
    params = jlayer.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    tree = jax.tree_util.tree_map(np.asarray, params)
    tlayer.load_state_dict(flax_to_state_dict(tree, tlayer))
    y_j = np.asarray(jlayer.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        xt = _t(x)
        y_t = tlayer(nhwc_to_nchw(xt) if xt.ndim == 4 else xt)
        y_t = nchw_to_nhwc(y_t) if y_t.ndim == 4 else y_t
    return y_t.numpy(), y_j


@pytest.mark.parametrize("wn", [True, False])
def test_linear(wn):
    x = np.random.RandomState(0).randn(3, 5, 7).astype(np.float32)
    jl, tl = (jops.LinearWN, ops.LinearWN) if wn else (JLinear, ops.Linear)
    _close(*_layer_pair(jl(features=11, gain=ops.LEAKY_GAIN), tl(7, 11, ops.LEAKY_GAIN), x))


@pytest.mark.parametrize("k,s,p,s2d", [(1, 1, 0, False), (3, 1, 1, False), (4, 2, 1, False),
                                       (4, 2, 1, True)])
def test_conv2d_wn(k, s, p, s2d):
    """s2d is the JAX space-to-depth form of the 4x4/2 conv: the same conv."""
    x = np.random.RandomState(1).randn(2, 12, 10, 5).astype(np.float32)
    jl = jops.Conv2dWN(features=6, kernel_size=k, strides=s, padding=p, s2d=s2d)
    _close(*_layer_pair(jl, ops.Conv2dWN(5, 6, k, s, p), x, seed=k))


def test_conv2d_plain():
    x = np.random.RandomState(2).randn(2, 9, 9, 4).astype(np.float32)
    _close(*_layer_pair(JConv2d(features=3, kernel_size=3, padding=1),
                        ops.Conv2d(4, 3, 3, 1, 1), x))


@pytest.mark.parametrize("k,s,p", [(4, 2, 1), (3, 1, 1), (2, 2, 0)])
def test_conv_transpose2d_wn(k, s, p):
    x = np.random.RandomState(3).randn(2, 6, 5, 4).astype(np.float32)
    jl = jops.ConvTranspose2dWN(features=3, kernel_size=k, strides=s, padding=p)
    _close(*_layer_pair(jl, ops.ConvTranspose2dWN(4, 3, k, s, p), x, seed=s))


def test_transposed_conv_init_is_blockwise():
    """The port's own init, like the JAX one, is parity-constant across the
    stride lattice and starts with g = ||W||."""
    torch.manual_seed(0)
    layer = ops.ConvTranspose2dWN(4, 3, 4, 2, 1)
    w = layer.weight.detach()
    np.testing.assert_array_equal(w[..., 0::2, 0::2].numpy(), w[..., 1::2, 1::2].numpy())
    np.testing.assert_allclose(layer.g.detach().numpy(), float(torch.linalg.norm(w)),
                               rtol=1e-6)


def test_conv_seq():
    specs = [dict(features=8, kernel_size=4, strides=2, padding=1),
             dict(features=6, kernel_size=3, strides=1, padding=1),
             dict(features=4, kernel_size=4, strides=2, padding=1, transpose=True)]
    x = np.random.RandomState(4).randn(2, 16, 16, 3).astype(np.float32)
    for final in (False, True):
        _close(*_layer_pair(JConvSeq(specs, final_activation=final, s2d_max_ch=8),
                            ops.ConvSeq(3, specs, final_activation=final), x),
               what=f"final_activation={final}")


def test_leaky_relu_and_gain():
    x = np.random.RandomState(5).randn(1000).astype(np.float32)
    _close(ops.leaky_relu(_t(x)).numpy(), jops.leaky_relu(jnp.asarray(x)))
    assert ops.LEAKY_GAIN == jops.LEAKY_GAIN


def test_rodrigues_and_normalize():
    rng = np.random.RandomState(6)
    r = (rng.randn(64, 3) * 2).astype(np.float32)
    r[0] = 0.0
    _close(ops.rodrigues(_t(r)).numpy(), jops.rodrigues(jnp.asarray(r)), "rodrigues")
    for eps, v in ((0.0, r[1:]), (0.5, r)):  # eps guards the zero vector
        _close(ops.normalize(_t(v), eps=eps).numpy(), jops.normalize(jnp.asarray(v), eps=eps),
               f"normalize eps={eps}")


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("packed", [False, True])
def test_grid_sample_2d(align_corners, packed):
    """Both JAX forms (packed neighbourhood and four gathers), samples in and
    beyond the border."""
    rng = np.random.RandomState(7)
    img = rng.randn(2, 9, 11, 4).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 6, 7, 2)).astype(np.float32)
    ref = jops.grid_sample_2d(jnp.asarray(img), jnp.asarray(grid), align_corners=align_corners,
                              packed=packed)
    _close(ops.grid_sample_2d(_t(img), _t(grid), align_corners).numpy(), ref)


@pytest.mark.parametrize("out_hw", [(16, 16), (5, 7), (32, 20)])
def test_resize_bilinear(out_hw):
    """Down and up, square and not: the corner convention of
    jax.image.resize is checked here, not assumed."""
    img = np.random.RandomState(8).randn(2, 10, 12, 2).astype(np.float32)
    ref = jops.resize_bilinear(jnp.asarray(img), out_hw)
    _close(ops.resize_bilinear(_t(img), out_hw).numpy(), ref)


def test_generate_geomap():
    rng = np.random.RandomState(9)
    geo = rng.randn(2, 50, 3).astype(np.float32)
    tidx = rng.randint(0, 50, (3, 16, 16)).astype(np.int32)
    bary = rng.dirichlet(np.ones(3), (16, 16)).transpose(2, 0, 1).astype(np.float32)
    ref = jops.generate_geomap(jnp.asarray(geo), tidx, bary)
    _close(ops.generate_geomap(_t(geo), _t(tidx).long(), _t(bary)).numpy(), ref)


def test_compute_raydirs():
    rng = np.random.RandomState(10)
    n = 3
    q, _ = np.linalg.qr(rng.randn(n, 3, 3))
    rot = q.astype(np.float32)
    pos = (rng.randn(n, 3) * 400).astype(np.float32)
    focal = rng.uniform(300, 500, (n, 2)).astype(np.float32)
    princpt = rng.uniform(10, 20, (n, 2)).astype(np.float32)
    px, py = np.meshgrid(np.arange(24, dtype=np.float32), np.arange(20, dtype=np.float32))
    pix = np.tile(np.stack([px, py], -1)[None], (n, 1, 1, 1))
    ref = jops.compute_raydirs(*(jnp.asarray(a) for a in (pos, rot, focal, princpt, pix)),
                               256.0)
    got = ops.compute_raydirs(*(_t(a) for a in (pos, rot, focal, princpt, pix)), 256.0)
    for name, a, b in zip(("raypos", "raydir", "tminmax"), got, ref):
        _close(a.numpy(), b, name)


@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_3d(align_corners):
    rng = np.random.RandomState(11)
    vol = rng.randn(4, 5, 6, 3).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (7, 9, 3)).astype(np.float32)
    ref = jax_grid_sample_3d(jnp.asarray(vol), jnp.asarray(coords), align_corners)
    _close(grid_sample_3d(_t(vol), _t(coords), align_corners).numpy(), ref)
