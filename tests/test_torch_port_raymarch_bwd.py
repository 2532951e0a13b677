# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The backward of the port's raymarch (ava256_tpu_torch.ops.raymarch_cuda)
on the CPU, where the wrappers run the kernels' plain PyTorch versions.

- ``march_tiles_bwd_plain`` (the backward kernel's arithmetic, pass by pass)
  against ``torch.autograd`` through ``march_tiles_plain``: max |d| <= 1e-5
  max |grad| for the template, warp and affine gradients;
- the op's gradients (``mvp_raymarch_cuda``: autograd.Function, culling, the
  affine vjp) against ``mvp_raymarch_pallas`` in interpret mode, for primpos,
  primrot, primscale, template and warp, on the cases of the JAX suite
  (``tests/test_raymarch_pallas.py``): cosine > 0.9999, that suite's bar, and
  max |d| <= 1e-3 max |ref|.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` and
``tests/test_torch_port_cuda.py`` hold it against the plain version there.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ava256_tpu_torch.data.synthetic import raymarch_scene
from ava256_tpu_torch.models.raymarcher import Raymarcher
from ava256_tpu_torch.ops import raymarch_cuda as rc
from ava256_tpu_torch.ops.math3d import quaternion_to_matrix, rodrigues

from tests import _torch_port_threads  # noqa: F401
from ava256_tpu.ops.raymarch_pallas import mvp_raymarch_pallas

from tests.test_raymarch import make_scene
from tests.test_raymarch_pallas import _adversarial_scene

NAMES = ("primpos", "primrot", "primscale", "template", "warp")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("bs,warp,opaque,masked", [
    (4, True, False, False), (8, False, True, False), (2, False, False, False),
    (8, True, False, True),
])
def test_plain_backward_matches_autograd(bs, warp, opaque, masked):
    s = raymarch_scene(n=1, h=17, w=19, k3=2, bs=bs, warp=warp, seed=bs)
    if opaque:  # rays saturate: cotangents end at the saturation row
        s["template"][..., 3] *= 30.0
    t = {k: torch.from_numpy(np.array(v)) for k, v in s.items() if isinstance(v, np.ndarray)}
    dt, nbuf, tile = s["stepsize"], 64, 8
    tmm = t["tminmax"]
    tmm = torch.stack([tmm[..., 0], torch.minimum(tmm[..., 1], tmm[..., 0] + nbuf * dt)], -1)
    n, K = t["primpos"].shape[:2]
    pm = torch.ones(n, K)
    if masked:
        pm[:, ::3] = 0.0
    t_o, t_d, t_mm, gid, valid, _, _ = rc.tile_and_cull(
        t["raypos"], t["raydir"], tmm, t["primpos"], t["primscale"], pm, tile, 8, dt)
    scal = rc.candidate_affines(t["primpos"], rodrigues(t["primrvec"]), t["primscale"], gid,
                                valid).requires_grad_()
    tpl = t["template"].reshape(n * K, bs, bs, bs, 4).clone().requires_grad_()
    wrp = t["warp"].reshape(n * K, bs, bs, bs, 3).clone().requires_grad_() if warp else None
    g = torch.from_numpy(np.random.RandomState(0).randn(gid.shape[0], 4, tile * tile)
                         .astype(np.float32))
    gid32 = gid.to(torch.int32)
    out = rc.march_tiles_plain(gid32, scal, t_o, t_d, t_mm, tpl, wrp, dt, 8.0, 8.0, nbuf)
    (out * g).sum().backward()
    if opaque:
        assert float(out.detach()[:, 3].max()) == 1.0
    counts = {}
    with torch.no_grad():
        d_tpl, d_wrp, d_aff = rc.march_tiles_bwd(
            gid32, scal.detach(), t_o, t_d, t_mm, g, tpl.detach(),
            None if wrp is None else wrp.detach(), dt, 8.0, 8.0, nbuf)
        again = rc.march_tiles_bwd_plain(
            gid32, scal.detach(), t_o, t_d, t_mm, g, tpl.detach(),
            None if wrp is None else wrp.detach(), dt, 8.0, 8.0, nbuf, counts=counts)
    # on CPU tensors the wrapper is the plain version
    assert torch.equal(again[0], d_tpl) and torch.equal(again[2], d_aff)
    assert 0 < int(counts["chained_samples"]) <= int(counts["forward_samples"])
    ref_aff = torch.zeros_like(d_aff).index_add_(0, gid.reshape(-1), scal.grad.reshape(-1, 12))
    assert _rel(d_tpl, tpl.grad) <= 1e-5
    assert _rel(d_aff, ref_aff) <= 1e-5
    if warp:
        assert _rel(d_wrp, wrp.grad) <= 1e-5
    else:
        assert d_wrp is None


def test_affine_vjp_matches_autograd():
    rng = np.random.RandomState(3)
    pos, rvec, scale = (torch.from_numpy(rng.randn(2, 5, 3).astype(np.float32)) for _ in range(3))
    scale = scale.abs() + 0.5
    rot = rodrigues(rvec)
    leaves = [x.clone().requires_grad_() for x in (pos, rot, scale)]
    gid = torch.arange(10).reshape(2, 5)
    scal = rc.candidate_affines(*leaves, gid, torch.ones(2, 5, dtype=torch.bool))
    d_aff = torch.from_numpy(rng.randn(10, 12).astype(np.float32))
    (scal.reshape(10, 12) * d_aff).sum().backward()
    got = rc.affine_grads(pos, rot, scale, d_aff)
    for a, leaf in zip(got, leaves):
        assert _rel(a, leaf.grad) <= 1e-6


def _grads_both(s, warp=False, prim_mask=None, **kw):
    """d sum(march) / d (primpos, primrot, primscale, template[, warp]) from
    the JAX op in interpret mode and from the port's op on the CPU."""
    names = NAMES[: 5 if warp else 4]
    common = dict(fadescale=6.5, fadeexp=8.0, **kw)
    rp, rd, tmm = (jnp.asarray(s[k]) for k in ("raypos", "raydir", "tminmax"))
    prims = [jnp.asarray(s[k]) for k in names]
    mask_j = None if prim_mask is None else jnp.asarray(prim_mask)

    def loss_j(*p):
        return jnp.sum(mvp_raymarch_pallas(
            rp, rd, s["stepsize"], tmm, *p[:4], p[4] if warp else None, prim_mask=mask_j,
            interpret=True, **common))

    g_j = [np.asarray(g) for g in jax.grad(loss_j, argnums=tuple(range(len(prims))))(*prims)]
    rp, rd, tmm = (torch.from_numpy(np.array(s[k])) for k in ("raypos", "raydir", "tminmax"))
    leaves = [torch.from_numpy(np.array(s[k])).requires_grad_() for k in names]
    out = rc.mvp_raymarch_cuda(
        rp, rd, s["stepsize"], tmm, *leaves[:4], leaves[4] if warp else None,
        prim_mask=None if prim_mask is None else torch.from_numpy(prim_mask), device="cpu",
        **common)
    out.sum().backward()
    return names, g_j, [x.grad.numpy() for x in leaves]


def _assert_grads_close(names, g_j, g_t):
    for name, a, b in zip(names, g_j, g_t):
        assert np.isfinite(b).all(), name
        assert np.abs(a).max() > 0, name
        dp = float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum() + 1e-30))
        err = np.abs(a - b).max() / np.abs(a).max()
        assert dp > 0.9999 and err <= 1e-3, f"{name}: dp={dp}, max|d|/max|ref|={err}"


CASES = {
    # tests/test_raymarch_pallas.py, by test: gradients (rows=8), early-out
    # under adversarial overlap, nbuf truncation, warp field, prim_mask, bs=2
    "plain_rows8": lambda: (make_scene(N=1, H=17, W=17, k3=2, M=8),
                            dict(tile=8, max_hit=8, nbuf=64, rows=8)),
    "adversarial_early_out": lambda: (_adversarial_scene(), dict(tile=8, max_hit=32, nbuf=64)),
    "nbuf_truncation": lambda: (make_scene(N=1, H=9, W=9, k3=2, M=8),
                                dict(tile=8, max_hit=8, nbuf=8)),
    "warp": lambda: (make_scene(N=1, H=17, W=17, k3=2, M=8, warp=True),
                     dict(tile=8, max_hit=8, nbuf=64, warp=True)),
    "prim_mask": lambda: (make_scene(N=1, H=17, W=17, k3=3, M=8, seed=7),
                          dict(tile=8, max_hit=32, nbuf=64,
                               prim_mask=(np.random.RandomState(0).rand(1, 27) > 0.5)
                               .astype(np.float32))),
    "bs2": lambda: (make_scene(N=1, H=17, W=17, k3=2, M=2), dict(tile=8, max_hit=16, nbuf=64)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_gradients_match_pallas(case):
    s, kw = CASES[case]()
    names, g_j, g_t = _grads_both(s, **kw)
    _assert_grads_close(names, g_j, g_t)
    if case == "prim_mask":  # nothing leaks through a masked primitive's template
        off = kw["prim_mask"][0] < 0.5
        assert np.abs(g_t[3][:, off]).max() == 0.0 and np.abs(g_t[3][:, ~off]).max() > 0.0


def test_empty_scene_zero_gradient():
    s = make_scene(N=1, H=9, W=9, k3=2, M=4)
    s["primpos"] = s["primpos"] + 100.0
    rp, rd, tmm = (torch.from_numpy(np.array(s[k])) for k in ("raypos", "raydir", "tminmax"))
    leaves = [torch.from_numpy(np.array(s[k])).requires_grad_() for k in NAMES[:4]]
    out = rc.mvp_raymarch_cuda(rp, rd, s["stepsize"], tmm, *leaves, None, fadescale=6.5,
                               fadeexp=8.0, tile=8, max_hit=4, nbuf=32, device="cpu")
    assert float(out.sum()) == 0.0
    out.sum().backward()
    for x in leaves:
        assert float(x.grad.abs().max()) == 0.0


def test_raymarcher_backends_differentiate():
    """``Raymarcher(backend="cuda")`` no longer refuses autograd; its gradients
    agree with the oracle backend's plain autograd (summed-within-step
    differs from the oracle's sequential blend only where primitives overlap
    inside a step: cosine > 0.999)."""
    s = make_scene(N=1, H=17, W=17, k3=2, M=8)
    rp, rd, tmm = (torch.from_numpy(np.array(s[k])) for k in ("raypos", "raydir", "tminmax"))
    grads = {}
    for backend, opts in (("cuda", dict(tile=8, max_hit=8, nbuf=64)),
                          ("reference", dict(max_steps=20))):
        dec = {k: torch.from_numpy(np.array(s[k])).requires_grad_() for k in NAMES[:4]}
        rm = Raymarcher(1.0, dt=s["stepsize"], backend=backend, fadescale=6.5, fadeexp=8.0,
                        **opts)
        rgb, alpha, _ = rm(rp, rd, tmm, dec)
        (rgb.sum() + alpha.sum()).backward()
        grads[backend] = [dec[k].grad.numpy() for k in NAMES[:4]]
    for name, a, b in zip(NAMES, grads["reference"], grads["cuda"]):
        dp = float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum() + 1e-30))
        assert dp > 0.999, (name, dp)


def test_quaternion_to_matrix_matches_jax():
    from ava256_tpu.ops.math3d import quaternion_to_matrix as jax_q2m

    q = np.random.RandomState(5).randn(4, 7, 4).astype(np.float32)
    ref = np.asarray(jax_q2m(jnp.asarray(q)))
    got = quaternion_to_matrix(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
