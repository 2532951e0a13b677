# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The port's image metrics (``ava256_tpu_torch.train.metrics``) against the
JAX package's on the CPU, on seeded numpy images of odd and even sizes (so
XLA's uneven "SAME" padding of the stride-4 convolution and the stride-2
max-pool is exercised): PSNR and SSIM within 1e-5 relative, LPIPS within
1e-4 relative with random features and with a weights ``.npz`` (trained
layout: ``conv0..4`` [k, k, cin, cout], ``lin0..4``) written by the test."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ava256_tpu_torch.train import metrics

from tests import _torch_port_threads  # noqa: F401
from ava256_tpu.train import metrics as jax_metrics

SIZES = [(37, 50), (64, 64), (23, 31)]


def _pair(h, w, seed, noise=12.0):
    rng = np.random.RandomState(seed)
    x = (rng.rand(2, h, w, 3) * 255).astype(np.float32)
    y = np.clip(x + rng.randn(2, h, w, 3) * noise, 0, 255).astype(np.float32)
    return x, y


def _rel(got, ref):
    return abs(float(got) - float(ref)) / abs(float(ref))


@pytest.mark.parametrize("hw", SIZES)
def test_psnr_and_ssim_match_jax(hw):
    x, y = _pair(*hw, seed=hw[0])
    assert _rel(metrics.psnr(torch.from_numpy(x), torch.from_numpy(y)),
                jax_metrics.psnr(jnp.asarray(x), jnp.asarray(y))) < 1e-5
    got = metrics.ssim(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32
    assert _rel(got, jax_metrics.ssim(jnp.asarray(x), jnp.asarray(y))) < 1e-5
    assert float(metrics.ssim(torch.from_numpy(x), torch.from_numpy(x))) == pytest.approx(1.0)


@pytest.mark.parametrize("hw", SIZES)
def test_lpips_random_features_match_jax(hw, monkeypatch):
    monkeypatch.delenv("AVA256_LPIPS_WEIGHTS", raising=False)
    assert metrics.lpips_weights_path() is None
    x, y = _pair(*hw, seed=hw[1])
    got = metrics.lpips(torch.from_numpy(x), torch.from_numpy(y))
    ref = jax_metrics.lpips(jnp.asarray(x), jnp.asarray(y))
    assert _rel(got, ref) < 1e-4, (float(got), float(ref))
    assert float(metrics.lpips(torch.from_numpy(x), torch.from_numpy(x))) < 1e-6


@pytest.mark.parametrize("with_lin", [True, False])
def test_lpips_weights_file_matches_jax(tmp_path, monkeypatch, with_lin):
    rng = np.random.RandomState(5)
    arrays, cin = {}, 3
    for i, (cout, k, _) in enumerate(metrics._LPIPS_LAYERS):
        arrays[f"conv{i}"] = (rng.randn(k, k, cin, cout) * np.sqrt(1.0 / (k * k * cin))
                              ).astype(np.float32)
        if with_lin:
            arrays[f"lin{i}"] = rng.rand(cout).astype(np.float32)
        cin = cout
    path = tmp_path / "lpips.npz"
    np.savez(path, **arrays)
    monkeypatch.setenv("AVA256_LPIPS_WEIGHTS", str(path))
    assert metrics.lpips_weights_path() == jax_metrics.lpips_weights_path() == str(path)
    x, y = _pair(37, 50, seed=9, noise=30.0)
    got = metrics.lpips(torch.from_numpy(x), torch.from_numpy(y))
    ref = jax_metrics.lpips(jnp.asarray(x), jnp.asarray(y))
    assert _rel(got, ref) < 1e-4, (float(got), float(ref))
    rf = jax_metrics.lpips(jnp.asarray(x), jnp.asarray(y), weights_path="/nonexistent.npz")
    assert float(rf) != pytest.approx(float(ref))  # the file's filters were used


@pytest.mark.parametrize("n,k,s", [(37, 11, 4), (50, 11, 4), (64, 11, 4), (9, 3, 2), (8, 3, 2),
                                   (13, 5, 1)])
def test_same_padding_is_xla_s(n, k, s):
    lo, hi = metrics._same_pad(n, k, s)
    out = -(-n // s)
    assert (n + lo + hi - k) // s + 1 == out and hi - lo in (0, 1)
