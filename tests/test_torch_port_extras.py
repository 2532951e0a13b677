# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The port's small ops against the JAX package on the CPU: the step
raymarcher, the layers of ``ops/extras.py`` (weights carried across by
``convert``), weight-norm fusing, ``mean_ell_2`` and
``parse_ply_vertices_from_bytesio``. Inputs are seeded numpy arrays.

Tolerances: 1e-5 (rtol and atol) for the ops and layers, fp32 on both
sides with sums in other orders; the fused weights to 1e-6 of each
tensor's largest value; ``mean_ell_2`` on small integers (exact in fp32)
and the PLY parser compared exactly.
"""

import io

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch
from torch import nn

from ava256_tpu_torch.convert import flax_to_state_dict, load_flax
from ava256_tpu_torch.geometry.ply import parse_ply_vertices_from_bytesio
from ava256_tpu_torch.ops import (
    Conv2dWN, Conv2dWS, ConvTranspose2dWN, CoordConv2d, LinearWN, dilate2d, downsample2d,
    fuse_weightnorm, step_raymarch)
from ava256_tpu_torch.ops.layers import nchw_to_nhwc, nhwc_to_nchw
from ava256_tpu_torch.train.losses import mean_ell_2

from tests import _torch_port_threads  # noqa: F401
from ava256_tpu.geometry.ply import parse_ply_vertices_from_bytesio as jax_ply_bytesio
from ava256_tpu.ops import extras as jx
from ava256_tpu.ops import layers as jl
from ava256_tpu.ops.stepraymarch import step_raymarch as jax_step_raymarch
from ava256_tpu.train.losses import mean_ell_2 as jax_mean_ell_2

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _scene(seed, warp):
    """9x9 rays through a random RGBA volume (and a warp near identity)."""
    rng = np.random.RandomState(seed)
    n, h, w, m = 2, 9, 9, 8
    px, py = np.meshgrid(np.linspace(-0.8, 0.8, w), np.linspace(-0.8, 0.8, h))
    ro = np.tile(np.stack([px, py, np.full_like(px, -4.0)], -1)[None], (n, 1, 1, 1))
    rd = np.tile(np.array([0.05, -0.03, 1.0]), (n, h, w, 1))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    tmm = np.tile(np.array([0.0, 8.0]), (n, h, w, 1)) + 0.3 * rng.rand(n, h, w, 2)
    tpl = np.log1p(np.exp(rng.randn(n, m, m, m, 4) * 1.5))
    tpl[..., 3] *= 2.0
    wv = None
    if warp:
        g = np.stack(np.meshgrid(*([np.linspace(-1, 1, m)] * 3), indexing="ij")[::-1], -1)
        wv = (g[None] + 0.05 * rng.randn(n, m, m, m, 3)).astype(np.float32)
    f32 = [x.astype(np.float32) for x in (ro, rd, tmm, tpl)]
    return f32 + [wv]


@pytest.mark.parametrize("accum,warp", [("add", False), ("mult", False), ("add", True)])
def test_step_raymarch_matches_jax(accum, warp):
    ro, rd, tmm, tpl, wv = _scene(3, warp)
    ref = np.asarray(jax_step_raymarch(
        jnp.asarray(ro), jnp.asarray(rd), 0.1, jnp.asarray(tmm), jnp.asarray(tpl),
        None if wv is None else jnp.asarray(wv), accum=accum, max_steps=100))
    got = step_raymarch(*(torch.from_numpy(x) for x in (ro, rd)), 0.1, torch.from_numpy(tmm),
                        torch.from_numpy(tpl), None if wv is None else torch.from_numpy(wv),
                        accum=accum, max_steps=100)
    assert ref[..., 3].max() > 0.5  # the rays cross the volume
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("stride,padding", [(2, "reflect"), (1, 3), (2, 0)])
def test_downsample2d_matches_jax(stride, padding):
    x = np.random.RandomState(1).randn(2, 16, 15, 3).astype(np.float32)
    ref = np.asarray(jx.downsample2d(jnp.asarray(x), stride=stride, padding=padding))
    got = downsample2d(torch.from_numpy(x), stride=stride, padding=padding)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_dilate2d_matches_jax():
    x = (np.random.RandomState(2).rand(2, 12, 10, 2) > 0.8).astype(np.float32) * 3.0
    ref = np.asarray(jx.dilate2d(jnp.asarray(x), kernel_size=3, stride=1, padding=1))
    got = dilate2d(torch.from_numpy(x), kernel_size=3, stride=1, padding=1)
    assert ref.max() == 1.0
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("name", ["CoordConv2d", "Conv2dWS"])
def test_conv_layers_match_jax(name):
    x = np.random.RandomState(3).randn(2, 10, 9, 3).astype(np.float32)
    if name == "CoordConv2d":
        jmod = jx.CoordConv2d(features=4, kernel_size=3, strides=2, padding=1)
        port = CoordConv2d(3, 4, kernel_size=3, strides=2, padding=1)
    else:
        jmod = jx.Conv2dWS(features=4, kernel_size=3, strides=1, padding=1)
        port = Conv2dWS(3, 4, kernel_size=3, strides=1, padding=1)
    variables = _np(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.RandomState(4)  # non-trivial biases and gains
    params = {k: v + 0.1 * rng.randn(*v.shape).astype(np.float32)
              for k, v in variables["params"].items() if not isinstance(v, dict)}
    params.update({k: v for k, v in variables["params"].items() if isinstance(v, dict)})
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    load_flax(port, {"params": params})
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


class _JaxWN(fnn.Module):
    """A conv, a transposed conv and a dense layer, all weight-normalized."""

    @fnn.compact
    def __call__(self, x):
        x = jl.Conv2dWN(features=6, kernel_size=3, padding=1)(x)
        x = jl.ConvTranspose2dWN(features=5, kernel_size=4, strides=2, padding=1)(x)
        return jl.LinearWN(features=7)(x)


class _PortWN(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv2dWN_0 = Conv2dWN(3, 6, kernel_size=3, padding=1)
        self.ConvTranspose2dWN_0 = ConvTranspose2dWN(6, 5, kernel_size=4, strides=2, padding=1)
        self.LinearWN_0 = LinearWN(5, 7)

    def forward(self, x):
        x = self.ConvTranspose2dWN_0(self.Conv2dWN_0(nhwc_to_nchw(x)))
        return self.LinearWN_0(nchw_to_nhwc(x))


def test_fuse_weightnorm_keeps_outputs_and_matches_jax():
    x = np.random.RandomState(5).randn(2, 6, 5, 3).astype(np.float32)
    params = _np(_JaxWN().init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    rng = np.random.RandomState(6)  # g away from ||w|| so that fusing is not trivial
    for layer in params.values():
        layer["g"] = layer["g"] * (1.0 + rng.rand(*layer["g"].shape).astype(np.float32))
    ref = np.asarray(_JaxWN().apply({"params": params}, jnp.asarray(x)))

    port = load_flax(_PortWN(), {"params": params})
    with torch.no_grad():
        unfused = port(torch.from_numpy(x))
        assert fuse_weightnorm(port) is port
        fused = port(torch.from_numpy(x))
    np.testing.assert_allclose(unfused.numpy(), ref, **TOL)
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), **TOL)

    sd = port.state_dict()
    assert not [k for k in sd if k.endswith(".g")]
    jax_fused = flax_to_state_dict({"params": _np(jx.fuse_weightnorm(params))}, port)
    assert sorted(jax_fused) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_allclose(v.numpy(), jax_fused[k].numpy(), rtol=0,
                                   atol=1e-6 * float(jax_fused[k].abs().max()), err_msg=k)


def test_mean_ell_2_matches_jax():
    rng = np.random.RandomState(7)
    a = rng.randint(-20, 20, size=(4, 8, 8, 3)).astype(np.float32)
    b = rng.randint(-20, 20, size=(4, 8, 8, 3)).astype(np.float32)
    ref = np.asarray(jax_mean_ell_2(jnp.asarray(a), jnp.asarray(b)))
    got = mean_ell_2(torch.from_numpy(a), torch.from_numpy(b))
    assert got.item() == float(ref)


def test_parse_ply_vertices_from_bytesio_matches_jax():
    verts = np.random.RandomState(8).randn(50, 3).astype(np.float32)
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 50\n"
              "property float x\nproperty float y\nproperty float z\n"
              "element face 0\nproperty list uchar int vertex_indices\nend_header\n")
    data = header.encode() + verts.astype("<f4").tobytes()
    ref = jax_ply_bytesio(io.BytesIO(data))
    got = parse_ply_vertices_from_bytesio(io.BytesIO(data))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, verts)
