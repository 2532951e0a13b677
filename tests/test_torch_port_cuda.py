# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The CUDA raymarch kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor the JAX package, so it runs on a machine with only
PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Without a card every test skips. Forward tolerance 1e-5: the kernel runs the
plain version's fp32 operations in the same order (built without FMA
contraction); what remains is ulp-level ``expf`` and division rounding. The
backward kernel sums over rays, rows and tiles with floating-point atomics, in
an order that changes from run to run: its gradients are held to
max |d| <= BWD_TOL * max |ref| and cosine > 0.99999.
"""

import numpy as np
import pytest
import torch

from ava256_tpu_torch.data.synthetic import raymarch_scene
from ava256_tpu_torch.ops import raymarch_cuda as rc
from ava256_tpu_torch.ops.math3d import rodrigues

pytestmark = pytest.mark.cuda
BWD_TOL = 2e-5
GRAD_NAMES = ("primpos", "primrot", "primscale", "template", "warp")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _args(s, dev):
    t = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in s.items()
         if isinstance(v, np.ndarray)}
    return (t["raypos"], t["raydir"], s["stepsize"], t["tminmax"], t["primpos"],
            rodrigues(t["primrvec"]), t["primscale"], t["template"], t.get("warp"))


@pytest.mark.parametrize("bs,warp,tile,opaque", [
    (8, False, 16, False), (8, True, 8, False), (4, True, 16, False), (2, False, 8, False),
    (8, False, 16, True),  # rays saturate: the windowed early exit
])
def test_kernel_matches_plain(card, bs, warp, tile, opaque):
    s = raymarch_scene(n=2, h=37, w=35, k3=3, bs=bs, warp=warp, seed=bs)
    if opaque:
        s["template"][..., 3] *= 30.0
    mask = torch.from_numpy((np.random.RandomState(0).rand(2, 27) > 0.3).astype(np.float32))
    kw = dict(fadescale=6.5, fadeexp=8.0, tile=tile, max_hit=27, nbuf=64)
    ref = rc.mvp_raymarch_cuda(*_args(s, "cpu"), prim_mask=mask, device="cpu", **kw)
    before = rc.march_tiles_kernel.launches
    out = rc.mvp_raymarch_cuda(*_args(s, card), prim_mask=mask.to(card), device=card, **kw)
    torch.cuda.synchronize()
    assert rc.march_tiles_kernel.launches == before + 1
    assert ref[..., 3].max() > 0.5
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_kernel_rejects_what_it_does_not_take(card):
    s = raymarch_scene(n=1, h=16, w=16, k3=2, bs=8)
    args = list(_args(s, card))
    with pytest.raises(ValueError, match="multiple of 32"):
        rc.mvp_raymarch_cuda(*args, tile=4, device=card)
    args[7] = args[7].double()
    with pytest.raises(ValueError, match="float32"):
        rc.mvp_raymarch_cuda(*args, tile=8, device=card)


def _op_grads(s, dev, mask, g, kw):
    """Gradients of sum(op * g) in primpos, primrot, primscale, template, warp."""
    args = list(_args(s, dev))
    leaves = [a.detach().requires_grad_() if a is not None else None for a in args[4:9]]
    out = rc.mvp_raymarch_cuda(*args[:4], *leaves, prim_mask=mask.to(dev), device=dev, **kw)
    (out * g.to(dev)).sum().backward()
    return out.detach(), [None if x is None else x.grad for x in leaves]


@pytest.mark.parametrize("bs,warp,tile,opaque", [
    (8, False, 16, False), (8, True, 8, False), (4, True, 16, False), (2, False, 8, False),
    (16, False, 8, False),
    (8, False, 16, True),  # rays saturate: cotangents end at the saturation row
])
def test_bwd_kernel_matches_plain(card, bs, warp, tile, opaque):
    s = raymarch_scene(n=2, h=37, w=35, k3=3, bs=bs, warp=warp, seed=bs)
    if opaque:
        s["template"][..., 3] *= 30.0
    mask = torch.from_numpy((np.random.RandomState(0).rand(2, 27) > 0.3).astype(np.float32))
    g = torch.from_numpy(np.random.RandomState(1).randn(2, 37, 35, 4).astype(np.float32))
    kw = dict(fadescale=6.5, fadeexp=8.0, tile=tile, max_hit=27, nbuf=64)
    _, ref = _op_grads(s, "cpu", mask, g, kw)
    before = rc.march_tiles_bwd_kernel.launches
    _, got = _op_grads(s, card, mask, g, kw)
    torch.cuda.synchronize()
    assert rc.march_tiles_bwd_kernel.launches == before + 1
    for name, a, b in zip(GRAD_NAMES, got, ref):
        if b is None:
            assert a is None and name == "warp"
            continue
        a, b = a.cpu().double(), b.double()
        assert torch.isfinite(a).all() and float(b.abs().max()) > 0, name
        err = float((a - b).abs().max() / b.abs().max())
        cos = float((a * b).sum() / torch.sqrt((a * a).sum() * (b * b).sum()))
        print(f"bs={bs} warp={warp} {name}: max|d|/max|ref| {err:.3g} cos {cos:.8f}")
        assert err <= BWD_TOL and cos > 0.99999, (name, err, cos)
