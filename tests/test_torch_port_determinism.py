# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""A training step that repeats bit for bit, as the JAX package's does on the
TPU, on the CPU at the tests' reduced size:

- **resume**: ``loop.run`` for 4 steps with a checkpoint after every step,
  then a second run that finds the step-2 checkpoint and goes on to step 4:
  its step-4 checkpoint (parameters, adaptwarps, Adam moments, step, the
  learning rate) and its losses of steps 2 and 3 equal the straight run's
  bit for bit, in float32 and in bfloat16;
- **mode**: every path ``factory.get_autoencoder`` builds runs under
  ``torch.use_deterministic_algorithms(True)`` in its raising mode, with
  cuDNN's autotuner off and ``CUBLAS_WORKSPACE_CONFIG`` set at import (a
  value the user set kept): one step on each raymarch backend, and a render;
- **fixed point** (``ops/fixed_point.py``, ``csrc/fixed_point.cuh``),
  restated in numpy: the scale, the rounding, the int64 sum and the way back
  to float; any order of the addends gives the same bits, the result lies
  within n * 2^-(k+1) (plus half an ulp) of the exact sum, and an addend out
  of range is reported; ``index_add_exact`` is order-free; the backward
  kernel's bounds hold on the small scenes (each at least the sum of |the
  gradients|);
- the order-free pieces the determinism needed elsewhere: the sub-pixel
  transposed convolution (the card's form) equals ``F.conv_transpose2d``,
  and the compacted marcher's prefix sum equals ``cumsum``.

The kernels' own repeats run on the card (``tests/test_torch_port_cuda.py``,
``chip_smoke.py`` ``[repeat]``, ``[resume-exact]``).
"""

import logging
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ava256_tpu_torch.data.loader import Uploader
from ava256_tpu_torch.data.synthetic import none_collate, raymarch_scene
from ava256_tpu_torch.flagship_runs import compare_checkpoints
from ava256_tpu_torch.ops import fixed_point
from ava256_tpu_torch.ops import raymarch_cuda as rc
from ava256_tpu_torch.ops.layers import conv_transpose2d, conv_transpose2d_subpixel
from ava256_tpu_torch.ops.math3d import rodrigues
from ava256_tpu_torch.ops.raymarch_xla import _prefix_sum
from ava256_tpu_torch.render import decode
from ava256_tpu_torch.train import loop
from ava256_tpu_torch.train.state import TrainState, make_optimizer
from ava256_tpu_torch.train.step import make_train_step, step_generator

from tests import _torch_port_threads  # noqa: F401

DTYPES = {"fp32": [], "bf16": ["model.dtype=bfloat16"]}


def _tiny_flagship(tmp_path, run, *more):
    """The flagship yaml reduced to a CPU size (as tests/test_torch_port_train.py)."""
    from ava256_tpu_torch.config import load_config
    from ava256_tpu_torch.data.synthetic import write_topology_obj

    write_topology_obj(tmp_path / "assets" / "face_topology.obj")
    return load_config("configs/config-synthetic-flagship.yaml", [
        f"assets={tmp_path / 'assets'}", f"progress.output_path={tmp_path / run}",
        "train.nids=2", "data.synthetic_frames=1", "data.synthetic_height=16",
        "data.synthetic_width=16", "data.synthetic_texsize=64", "model.nprims=256",
        "model.primsize=16", "train.batchsize=2", "model.raymarch.tile=8",
        "model.raymarch.max_hit=16", "model.raymarch.nbuf=32", "train.warmup_iters=1",
        "train.lr_scheduler_iter=2", "train.num_workers=1", *more])


def _recording(monkeypatch):
    """Each step's loss and loss terms, as floats, in the order taken."""
    seen = []
    make = loop.make_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def recorded(state, batch, **kw):
            state, loss, terms = step(state, batch, **kw)
            seen.append((float(loss), {k: float(v) for k, v in terms.items()}))
            return state, loss, terms

        return recorded

    monkeypatch.setattr(loop, "make_train_step", recording)
    return seen


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_resumed_run_retraces_the_straight_run(tmp_path, monkeypatch, caplog, dtype):
    monkeypatch.setenv("AVA256_CACHE_DIR", str(tmp_path / "cache"))
    seen = _recording(monkeypatch)
    opts = ["train.maxiter=4", "train.checkpoint_every=1"] + DTYPES[dtype]
    straight = loop.run(_tiny_flagship(tmp_path, "straight", *opts), device="cpu")
    assert straight.step == 4 and len(seen) == 4
    whole = list(seen)
    # a preempted run finds its step-2 checkpoint and goes on
    (tmp_path / "resumed" / "checkpoints").mkdir(parents=True)
    shutil.copy(tmp_path / "straight" / "checkpoints" / "step_00000002.pt",
                tmp_path / "resumed" / "checkpoints")
    seen.clear()
    with caplog.at_level(logging.INFO, logger="ava256_tpu_torch.train"):
        resumed = loop.run(_tiny_flagship(tmp_path, "resumed", *opts), device="cpu")
    assert any(r.getMessage().startswith("Resumed from") and "step 2" in r.getMessage()
               for r in caplog.records)
    assert resumed.step == 4 and seen == whole[2:]
    final = [tmp_path / run / "checkpoints" / "step_00000004.pt"
             for run in ("straight", "resumed")]
    assert compare_checkpoints(*final) == []
    ckpt = torch.load(final[0], map_location="cpu", weights_only=True)
    moments = [s["exp_avg_sq"] for s in ckpt["optimizer"]["state"].values()]
    assert ckpt["step"] == 4 and moments and all(bool((m > 0).any()) for m in moments[:5])


# ---------------------------------------------------------------------------
# mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_every_backend_steps_and_renders_under_the_raising_mode(tmp_path, monkeypatch,
                                                                 backend):
    monkeypatch.setenv("AVA256_CACHE_DIR", str(tmp_path / "cache"))
    torch.use_deterministic_algorithms(False)
    # 2 rows of dt 16 / 256 per box: the oracle (reference) steps every ray
    # through the whole volume, which at the yaml's dt 1 takes minutes here
    cfg = _tiny_flagship(tmp_path, "run", f"model.raymarch.backend={backend}",
                         "model.raymarch.dt=16.0")
    ds = loop.build_dataset(cfg)
    model = loop.build_model(cfg, ds, loop.load_uvdata(cfg), "cpu")
    assert torch.are_deterministic_algorithms_enabled()
    assert not torch.is_deterministic_algorithms_warn_only_enabled()
    assert not torch.backends.cudnn.benchmark
    assert not torch.utils.deterministic.fill_uninitialized_memory
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"]
    optimizer = make_optimizer(model)
    step = make_train_step(model, optimizer, dict(cfg.train.losses), ds.vertmean, ds.vertstd,
                           output_set=frozenset(cfg.train.output_set))
    batch = Uploader(torch.device("cpu")).now(loop.to_model_batch(none_collate([ds[0], ds[1]])))
    state, loss, _ = step(TrainState(model, optimizer, 0), batch,
                          generator=step_generator("cpu", 0), running_avg_scale=True)
    assert state.step == 1 and np.isfinite(float(loss))
    frame = decode(model, batch, batch["neut_avgtex"], batch["neut_verts"])
    assert frame.shape[-1] == 3 and bool(torch.isfinite(frame).all())


def test_the_oracle_backend_differentiates_under_the_raising_mode():
    """``backend: reference`` (the oracle march) on a small scene, forward and
    backward under the mode the factory sets: a model step with it takes
    minutes on this CPU even at 8x8 rays, so its march alone is run here."""
    from ava256_tpu_torch.ops.raymarch_ref import mvp_raymarch_reference

    torch.use_deterministic_algorithms(True)
    s = raymarch_scene(n=1, h=9, w=7, k3=2, bs=4, warp=True, seed=3)
    t = {k: torch.from_numpy(np.array(v)).requires_grad_(k in ("primpos", "template", "warp"))
         for k, v in s.items() if isinstance(v, np.ndarray)}
    out = mvp_raymarch_reference(t["raypos"], t["raydir"], s["stepsize"], t["tminmax"],
                                 t["primpos"], rodrigues(t["primrvec"]), t["primscale"],
                                 t["template"], t["warp"])
    out.sum().backward()
    assert all(bool(torch.isfinite(t[k].grad).all()) for k in ("primpos", "template", "warp"))


def test_cublas_workspace_is_set_at_import_and_a_users_value_kept():
    code = "import os, ava256_tpu_torch; print(os.environ['CUBLAS_WORKSPACE_CONFIG'])"
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    got = [subprocess.run([sys.executable, "-c", code], env=e, capture_output=True, text=True,
                          check=True, cwd=root).stdout.strip()
           for e in (env, dict(env, CUBLAS_WORKSPACE_CONFIG=":16:8"))]
    assert got == [":4096:8", ":16:8"]


# ---------------------------------------------------------------------------
# fixed point, restated in numpy
# ---------------------------------------------------------------------------


def _np_scale(bound: float) -> float:
    """2^k with k = clip(floor(61 - log2 B), -126, 126); NaN for a bound that
    is not finite."""
    if not np.isfinite(bound):
        return float("nan")
    with np.errstate(divide="ignore"):
        k = np.clip(np.floor(61.0 - np.log2(bound)), -126, 126)
    return float(np.float32(2.0 ** k))


def _np_to_fixed(x: np.ndarray, scale: float):
    """fxp::add's value: round(x * scale) to the nearest int64 (ties to
    even), or nothing and a flag where |x * scale| is not below 2^62."""
    y = x.astype(np.float32) * np.float32(scale)
    bad = ~(np.abs(y) < np.float32(2.0**62))
    return np.where(bad, 0, np.rint(np.where(bad, 0, y))).astype(np.int64), bool(bad.any())


def _np_to_float(q: np.int64, scale: float) -> np.float32:
    return np.float32(q) * np.float32(1.0 / scale)


@pytest.mark.parametrize("bound", [1.0, 3.7e-7, 6.1e12, 0.0, 1e-45, 1e38, float("inf"),
                                   float("nan")])
def test_scale_matches_its_restatement(bound):
    got = float(fixed_point.scale_for(torch.tensor(bound, dtype=torch.float64)))
    want = _np_scale(bound)
    assert (np.isnan(got) and np.isnan(want)) or got == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fixed_point_sum_is_order_free_and_close(seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(5000) * np.exp(rng.uniform(-12, 4, 5000))).astype(np.float32)
    scale = _np_scale(float(np.abs(x.astype(np.float64)).sum()))
    q, bad = _np_to_fixed(x, scale)
    assert not bad
    sums, floats = set(), set()
    for _ in range(6):
        perm = rng.permutation(len(x))
        sums.add(_np_to_float(np.sum(q[perm]), scale).tobytes())
        acc = np.float32(0.0)
        for v in x[perm[:800]]:
            acc = np.float32(acc + v)
        floats.add(acc.tobytes())
    assert len(sums) == 1  # the same bits in every order
    assert len(floats) > 1  # a float sum is not order-free: what the fixed point is for
    got = np.frombuffer(sums.pop(), np.float32)[0]
    exact = float(np.sum(x.astype(np.float64)))
    limit = len(x) * 0.5 / scale + 0.5 * float(np.spacing(np.float32(abs(exact))))
    assert abs(float(got) - exact) <= limit


def test_out_of_range_is_reported():
    """An addend whose scaled value reaches 2^62 (a scale from a bound that
    was too small) is not added and sets the flag; ``check`` raises on a set
    flag and clears it."""
    x = np.array([1.0, 3.0e20, -2.0], np.float32)
    q, bad = _np_to_fixed(x, _np_scale(4.0))
    assert bad and q.tolist() == [2**59, 0, -(2**60)]
    flag = fixed_point.flag("cpu")
    flag.fill_(fixed_point.OUT_OF_RANGE)
    with pytest.raises(fixed_point.FixedPointOverflow, match="2\\^62"):
        fixed_point.check("cpu")
    assert int(flag) == 0
    fixed_point.check("cpu")
    flag.fill_(fixed_point.NEGATIVE_DENSITY)
    with pytest.raises(fixed_point.FixedPointOverflow, match="negative"):
        fixed_point.check("cpu")


def test_index_add_exact_is_order_free():
    g = torch.Generator().manual_seed(0)
    src = torch.randn(4000, 12, generator=g) * torch.exp(torch.randn(4000, 1, generator=g) * 4)
    idx = torch.randint(0, 37, (4000,), generator=g)
    ref = torch.zeros(37, 12, dtype=torch.float64).index_add_(0, idx, src.double())
    outs = []
    for _ in range(3):
        perm = torch.randperm(4000, generator=g)
        outs.append(fixed_point.index_add_exact(37, idx[perm], src[perm]))
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    err = (outs[0].double() - ref).abs().max() / ref.abs().max()
    assert float(err) < 1e-6


SCENES = [(2, False), (4, True), (8, False), (16, True)]


@pytest.mark.parametrize("bs,warp", SCENES)
def test_backward_bounds_hold_on_small_scenes(bs, warp):
    """Each bound of ``fixed_point_bounds`` is at least the sum of |the plain
    version's gradients| of its channel group (the gradients are sums of
    the addends the bound bounds), and the densities are >= 0."""
    s = raymarch_scene(n=2, h=21, w=19, k3=3, bs=bs, warp=warp, seed=bs)
    t = {k: torch.from_numpy(np.array(v)) for k, v in s.items() if isinstance(v, np.ndarray)}
    n, k = t["primpos"].shape[:2]
    dt, nbuf = float(s["stepsize"]), 64
    tmm = t["tminmax"]
    tmm = torch.stack([tmm[..., 0], torch.minimum(tmm[..., 1], tmm[..., 0] + nbuf * dt)], -1)
    t_o, t_d, t_mm, gid, valid, _, _ = rc.tile_and_cull(
        t["raypos"], t["raydir"], tmm, t["primpos"], t["primscale"], torch.ones(n, k), 8, 27, dt)
    scal = rc.candidate_affines(t["primpos"], rodrigues(t["primrvec"]), t["primscale"], gid,
                                valid)
    tpl = t["template"].reshape(n * k, bs, bs, bs, 4).contiguous()
    wrp = t["warp"].reshape(n * k, bs, bs, bs, 3).contiguous() if warp else None
    g = torch.randn(t_o.shape[0], 4, t_o.shape[2], generator=torch.Generator().manual_seed(5))
    d_tpl, d_wrp, _ = rc.march_tiles_bwd_plain(gid.int(), scal, t_o, t_d, t_mm, g, tpl, wrp,
                                               dt, 8.0, 8.0, nbuf)
    bounds, alpha_min = rc.fixed_point_bounds(g, scal, tpl, wrp, dt, 8.0, 8.0, nbuf)
    sums = [float(d_tpl[..., c].abs().sum()) for c in range(4)]
    sums.append(float(d_wrp.abs().sum()) if warp else 0.0)
    assert float(alpha_min) >= 0.0
    for c, (b, total) in enumerate(zip(bounds.tolist(), sums)):
        assert b >= total, (c, b, total)
    assert min(sums[:4]) > 0.0


# ---------------------------------------------------------------------------
# the other order-free pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cin,cout,k,s,p,h,w", [
    (8, 5, 4, 2, 1, 7, 9),   # the decoders' k4 s2 p1
    (3, 4, 4, 2, 1, 4, 4),
    (6, 2, 6, 3, 2, 5, 6),
    (4, 3, 4, 2, 0, 3, 5),
    (4, 4, 3, 1, 1, 5, 5),   # not a multiple of the stride: F.conv_transpose2d
])
def test_subpixel_conv_transpose_equals_f_conv_transpose2d(cin, cout, k, s, p, h, w):
    """The sub-pixel form (what ``conv_transpose2d`` runs on CUDA tensors)
    against F.conv_transpose2d; a kernel that is not a multiple of the stride
    goes to F.conv_transpose2d itself."""
    g = torch.Generator().manual_seed(cin * 31 + k)
    x = torch.randn(2, cin, h, w, dtype=torch.float64, generator=g).requires_grad_()
    wt = torch.randn(cin, cout, k, k, dtype=torch.float64, generator=g).requires_grad_()
    b = torch.randn(cout, dtype=torch.float64, generator=g).requires_grad_()
    fn = conv_transpose2d_subpixel if k % s == 0 and s > 1 else conv_transpose2d
    got = fn(x, wt, b, (s, s), (p, p))
    ref = F.conv_transpose2d(x, wt, b, s, p)
    assert got.shape == ref.shape
    gout = torch.randn(ref.shape, dtype=torch.float64, generator=g)
    grads = [torch.autograd.grad(o, (x, wt, b), gout) for o in (got, ref)]
    assert float((got - ref).detach().abs().max()) < 1e-12
    for a, r in zip(*grads):
        assert float((a - r).abs().max()) < 1e-12


def test_subpixel_conv_transpose_trains_after_inference_mode():
    """The phase indices are cached; the first call may come from a render
    under torch.inference_mode(), and a training step after it must still
    differentiate (autograd saves the indices)."""
    from ava256_tpu_torch.ops import layers

    layers._phase_taps.cache_clear()
    x = torch.randn(1, 3, 4, 4)
    w = torch.randn(3, 2, 4, 4, requires_grad=True)
    with torch.inference_mode():
        conv_transpose2d_subpixel(x, w.detach(), None, (2, 2), (1, 1))
    conv_transpose2d_subpixel(x, w, None, (2, 2), (1, 1)).sum().backward()
    assert w.grad is not None and bool(torch.isfinite(w.grad).all())


def test_prefix_sum_equals_cumsum():
    x = torch.randn(3, 5, 97, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    assert float((_prefix_sum(x) - torch.cumsum(x, dim=-1)).abs().max()) < 1e-12
