# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The port's raymarch (ava256_tpu_torch.ops.raymarch_cuda / raymarch_ref)
against the JAX package on the CPU.

- the culler must pick the same candidates as ``_tile_and_cull``, dense and
  two-stage, and on 65,536 boxes (the two-stage branch the configurations
  take) the same as the benchmark's plain reference (``benchmark/reference``);
- the march (on CPU tensors: the kernel's plain PyTorch version) must match
  ``mvp_raymarch_pallas`` in interpret mode to rtol/atol 1e-4, the JAX
  suite's image tolerance;
- the PyTorch oracle must match ``mvp_raymarch_reference`` in both
  within_step modes (float32, same formula: 1e-5 relative).

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` and
``tests/test_torch_port_cuda.py`` hold it against the plain version there.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ava256_tpu_torch.data.synthetic import raymarch_scene
from ava256_tpu_torch.ops import raymarch_cuda as rc
from ava256_tpu_torch.ops.raymarch_ref import mvp_raymarch_reference

from tests import _torch_port_threads  # noqa: F401
from ava256_tpu.ops.raymarch_pallas import _tile_and_cull, mvp_raymarch_pallas
from ava256_tpu.ops.raymarch_ref import mvp_raymarch_reference as jax_reference

from benchmark.reference import march as bench_march
from tests.test_raymarch import make_scene
from tests.test_raymarch_pallas import _adversarial_scene

KEYS = ("primpos", "primrot", "primscale", "template")


def _torch(s, *names):
    return [None if s[k] is None else torch.from_numpy(np.array(s[k]))
            for k in names]


def _march_both(s, warp=False, prim_mask=None, **kw):
    names = ("raypos", "raydir", "tminmax") + KEYS + (("warp",) if warp else ())
    common = dict(fadescale=6.5, fadeexp=8.0, **kw)
    rp, rd, tmm, *prims = [jnp.asarray(s[k]) for k in names]
    out_j = mvp_raymarch_pallas(
        rp, rd, s["stepsize"], tmm, *prims[:4], prims[4] if warp else None,
        prim_mask=None if prim_mask is None else jnp.asarray(prim_mask),
        interpret=True, **common)
    rp, rd, tmm, *prims = _torch(s, *names)
    out_t = rc.mvp_raymarch_cuda(
        rp, rd, s["stepsize"], tmm, *prims[:4], prims[4] if warp else None,
        prim_mask=None if prim_mask is None else torch.from_numpy(prim_mask),
        device="cpu", **common)
    return np.asarray(out_j), out_t.numpy()


@pytest.mark.parametrize("two_stage,max_hit,groups", [
    (False, 64, 4),  # every live prim kept, the masked ones invalid
    (False, 24, 4),  # max_hit cuts the depth order
    (True, 64, 4),  # two-stage, all four groups of 16 kept
    (True, 64, 3),  # two-stage, a group truncated
])
def test_culler_matches_jax(two_stage, max_hit, groups):
    s = make_scene(N=2, H=17, W=17, k3=4, M=4, seed=5)
    rng = np.random.RandomState(0)
    mask = (rng.rand(2, 64) > 0.2).astype(np.float32)
    kw = dict(tile=8, max_hit=max_hit, dt=s["stepsize"], cull_group_size=16,
              cull_max_groups=groups, two_stage=two_stage)
    j = _tile_and_cull(*(jnp.asarray(s[k]) for k in ("raypos", "raydir", "tminmax",
                                                     "primpos", "primscale")),
                       jnp.asarray(mask), **kw)
    t = rc.tile_and_cull(*_torch(s, "raypos", "raydir", "tminmax", "primpos", "primscale"),
                         torch.from_numpy(mask), **kw)
    for name, a, b in zip(("t_o", "t_d", "t_mm"), j[:3], t[:3]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    valid_j, valid_t = np.asarray(j[4]), t[4].numpy()
    np.testing.assert_array_equal(valid_j, valid_t)
    assert valid_t.sum() > 0
    np.testing.assert_array_equal(np.asarray(j[3]), t[3].numpy())
    np.testing.assert_allclose(np.where(valid_j, np.asarray(j[5]), 0.0),
                               np.where(valid_t, t[5].numpy(), 0.0), rtol=1e-6, atol=1e-6)


def test_two_stage_cull_matches_the_benchmark_reference():
    """65,536 boxes, so both take the two-stage branch by default: a tile's
    candidates (ids, depth order, validity) equal the reference's, with the
    group cap and the candidate cap both cutting."""
    s = raymarch_scene(n=2, h=16, w=16, k3=2, bs=2, seed=18)
    rng = np.random.RandomState(18)
    K = 65536
    primpos = torch.from_numpy((rng.rand(2, K, 3) * 0.6 - 0.3).astype(np.float32))
    primscale = torch.from_numpy(rng.uniform(20.0, 60.0, (2, K, 3)).astype(np.float32))
    raypos, raydir, tminmax = _torch(s, "raypos", "raydir", "tminmax")
    spy = []
    smallest = rc._smallest
    rc_args = (raypos, raydir, tminmax, primpos, primscale, torch.ones(2, K))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rc, "_smallest", lambda key, k: spy.append(smallest(key, k)) or spy[-1])
        t_o, t_d, t_mm, gid, valid, _, meta = rc.tile_and_cull(*rc_args, tile=8, max_hit=64,
                                                               dt=s["stepsize"])
    groups_kept, cands = spy  # two-stage: the earliest groups, then the members
    assert groups_kept[1].shape == (8, 8) and cands[1].shape == (8, 64)
    tiles = bench_march._tiles
    assert torch.equal(t_o, tiles(raypos, 8)) and torch.equal(t_mm, tiles(tminmax, 8))
    tile_b = torch.arange(meta["ntiles"]) // (meta["nty"] * meta["ntx"])
    ref_gid, ref_valid = bench_march.cull(t_o, t_d, t_mm, primpos, primscale, tile_b, 64,
                                          s["stepsize"], 256, 8)
    np.testing.assert_array_equal(valid.numpy(), ref_valid.numpy())
    np.testing.assert_array_equal(gid.numpy(), ref_gid.numpy())
    assert bool(torch.isfinite(groups_kept[0]).all(dim=1).any())  # a tile's 8 slots full
    assert bool(valid.all(dim=1).any()) and int(valid.sum()) > 64


@pytest.mark.parametrize("case", ["plain", "warp", "bs2", "bs4_warp", "prim_mask"])
def test_march_matches_pallas(case):
    warp = "warp" in case
    M = {"bs2": 2, "bs4_warp": 4}.get(case, 8)
    k3 = 4 if case == "bs2" else 2
    s = make_scene(N=2, H=17, W=17, k3=k3, M=M, warp=warp, seed=11)
    mask = None
    if case == "prim_mask":
        mask = (np.random.RandomState(1).rand(2, k3**3) > 0.5).astype(np.float32)
    a, b = _march_both(s, warp=warp, prim_mask=mask, tile=8, max_hit=max(16, k3**3), nbuf=64)
    assert np.abs(a).max() > 0.05
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def test_march_early_out_adversarial():
    """A saturating wall in front of a huge far-centred primitive: the
    windowed early exit must equal the full composite."""
    a, b = _march_both(_adversarial_scene(), tile=8, max_hit=32, nbuf=64)
    assert a[..., 3].max() > 0.99
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def test_march_nbuf_truncation():
    """A small nbuf is a shorter march (the oracle's max_steps), in both ports."""
    s = make_scene(N=1, H=9, W=9, k3=2, M=8)
    a, b = _march_both(s, tile=8, max_hit=8, nbuf=8)
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
    ref = mvp_raymarch_reference(*_torch(s, "raypos", "raydir"), s["stepsize"],
                                 *_torch(s, "tminmax", *KEYS), None, fadescale=6.5,
                                 fadeexp=8.0, max_steps=8)
    np.testing.assert_allclose(b, ref.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("within_step", ["sequential", "summed"])
@pytest.mark.parametrize("warp", [False, True])
def test_oracle_matches_jax(within_step, warp):
    s = make_scene(N=1, H=9, W=9, k3=2, M=4, warp=warp, seed=3)
    steps = int(np.ceil(s["tminmax"][..., 1].max() / s["stepsize"])) + 2
    names = ("raypos", "raydir", "tminmax") + KEYS
    j = jax_reference(*(jnp.asarray(s[k]) for k in names[:2]), s["stepsize"],
                      *(jnp.asarray(s[k]) for k in names[2:]),
                      None if not warp else jnp.asarray(s["warp"]), fadescale=6.5,
                      fadeexp=8.0, max_steps=steps, within_step=within_step)
    t = mvp_raymarch_reference(*_torch(s, *names[:2]), s["stepsize"], *_torch(s, *names[2:]),
                               _torch(s, "warp")[0] if warp else None, fadescale=6.5,
                               fadeexp=8.0, max_steps=steps, within_step=within_step)
    j = np.asarray(j)
    assert np.abs(j).max() > 0.05
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-5 * np.abs(j).max())


def test_cuda_op_needs_cuda_or_cpu_device():
    s = make_scene(N=1, H=9, W=9, k3=2, M=4)
    args = _torch(s, "raypos", "raydir")
    rest = _torch(s, "tminmax", *KEYS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rc.mvp_raymarch_cuda(*args, s["stepsize"], *rest)
    with pytest.raises(ValueError, match="primsize"):
        rc.mvp_raymarch_cuda(*args, s["stepsize"], *rest[:4],
                             torch.zeros(1, 8, 3, 3, 3, 4), device="cpu")

