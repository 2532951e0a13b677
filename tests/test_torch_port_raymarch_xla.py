# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The port's compacted marcher (``ava256_tpu_torch.ops.raymarch_xla``) and
its ``xla`` backend against the JAX package on the CPU.

Inputs are ``tests/test_raymarch.py``'s scenes (numpy, seeded). Tolerances:
- against JAX's ``mvp_raymarch_xla``: the output at rtol = atol = 1e-4; the
  gradients of a seeded cotangent (template, primpos, primrot, primscale,
  and warp where there is one) at cosine > 0.9999 and max |d| <= 1e-3 max
  |ref| (fp32 on both sides; sums in other orders);
- against the port's oracle: the JAX test's cosines (0.9999 output, 0.999
  gradients), since the oracle composites in index order, the marcher near
  to far;
- the autoencoder with ``raymarch_backend="xla"`` against JAX's: 1e-4 of the
  largest value plus 1e-4, as ``test_torch_port_model.py``.
"""

import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ava256_tpu_torch import kbench
from ava256_tpu_torch.config import load_config
from ava256_tpu_torch.convert import load_flax
from ava256_tpu_torch.data.synthetic import (
    SyntheticDataset, none_collate, raymarch_scene, synthetic_uvdata)
from ava256_tpu_torch.factory import get_autoencoder
from ava256_tpu_torch.ops.math3d import rodrigues
from ava256_tpu_torch.ops.raymarch_ref import mvp_raymarch_reference
from ava256_tpu_torch.ops.raymarch_xla import march_compacted, mvp_raymarch_xla
from ava256_tpu_torch.train import loop

from tests import _torch_port_threads  # noqa: F401
from ava256_tpu.ops.raymarch_xla import mvp_raymarch_xla as jax_xla
from ava256_tpu.train.step import BATCH_MODEL_KEYS
from tests.test_raymarch import make_scene

LEAVES = ("template", "primpos", "primrot", "primscale", "warp")
KW = dict(fadescale=6.5, fadeexp=7.5, tile=8, max_hit=32, max_samples=512, chunk_tiles=16)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum() + 1e-30))


def _grad_close(name, got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    cos = _cos(got, ref)
    assert cos > 0.9999 and err <= 1e-3, f"{name}: cosine {cos}, max|d|/max|ref| {err:.3g}"


def _jax_run(s, cot, warp, **kw):
    """JAX's output and its vjp of cot in the leaves."""
    prims = [jnp.asarray(s[k]) for k in LEAVES[:4]] + ([jnp.asarray(s["warp"])] if warp else [])

    def f(tpl, pp, pr, ps, *wp):
        return jax_xla(jnp.asarray(s["raypos"]), jnp.asarray(s["raydir"]), s["stepsize"],
                       jnp.asarray(s["tminmax"]), pp, pr, ps, tpl, wp[0] if wp else None, **kw)

    out, vjp = jax.vjp(f, *prims)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _port_run(s, cot, warp, march=mvp_raymarch_xla, **kw):
    leaves = [_t(s[k]).requires_grad_() for k in LEAVES[:4]]
    leaves += [_t(s["warp"]).requires_grad_()] if warp else []
    out = march(_t(s["raypos"]), _t(s["raydir"]), s["stepsize"], _t(s["tminmax"]), leaves[1],
                leaves[2], leaves[3], leaves[0], leaves[4] if warp else None, **kw)
    (out * _t(cot)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("warp", [False, True])
def test_xla_matches_jax(warp):
    s = make_scene(N=2, H=33, W=33, k3=3, M=8, warp=warp)
    cot = np.random.RandomState(5).randn(2, 33, 33, 4).astype(np.float32)
    ref, gref = _jax_run(s, cot, warp, **KW)
    out, grads = _port_run(s, cot, warp, **KW)
    assert ref[..., 3].mean() > 0.3  # the rays meet the primitives
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    for name, got, want in zip(LEAVES, grads, gref):
        _grad_close(name, got, want)


@pytest.mark.parametrize("warp", [False, True])
def test_xla_matches_oracle(warp):
    s = make_scene(N=2, H=33, W=33, k3=3, M=8, warp=warp)
    cot = np.ones((2, 33, 33, 4), np.float32)
    max_steps = int(np.ceil(s["tminmax"][..., 1].max() / s["stepsize"])) + 2
    ref, gref = _port_run(s, cot, warp, march=mvp_raymarch_reference, fadescale=6.5,
                          fadeexp=7.5, max_steps=max_steps)
    out, grads = _port_run(s, cot, warp, **KW)
    assert _cos(out, ref) > 0.9999
    for name, got, want in zip(LEAVES[:4], grads, gref):
        assert _cos(got, want) > 0.999, name


def test_alpha_saturates_at_one():
    s = make_scene(N=1, H=17, W=17, k3=3, M=4)
    s["template"] = np.full_like(s["template"], 5.0)
    out, _ = _port_run(s, np.ones((1, 17, 17, 4), np.float32), False, tile=8, max_hit=32,
                       max_samples=128)
    assert out[..., 3].max() <= 1.0 + 1e-5
    assert out[..., 3].max() > 0.99


def test_empty_scene_renders_zero():
    s = make_scene(N=1, H=17, W=17, k3=2, M=4)
    s["primpos"] = s["primpos"] + 100.0
    out, grads = _port_run(s, np.ones((1, 17, 17, 4), np.float32), False, tile=8, max_hit=16,
                           max_samples=64)
    np.testing.assert_allclose(out, 0.0, atol=1e-6)
    assert all(np.abs(g).max() == 0.0 for g in grads)


def test_overflow_modes(caplog):
    """A budget of 4 samples truncates most rays: "warn" marches what fits
    (as JAX does) and logs the count, "error" gives NaN everywhere, any
    other value raises."""
    s = make_scene(N=1, H=17, W=17, k3=3, M=8)
    kw = dict(fadescale=6.5, fadeexp=7.5, tile=8, max_hit=32, max_samples=4, chunk_tiles=4)
    cot = np.random.RandomState(6).randn(1, 17, 17, 4).astype(np.float32)
    ref, gref = _jax_run(s, cot, False, **kw)
    with caplog.at_level(logging.WARNING, logger="ava256_tpu_torch.ops.raymarch_xla"):
        out, grads = _port_run(s, cot, False, **kw)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    for name, got, want in zip(LEAVES, grads, gref):
        _grad_close(name, got, want)
    _, count = march_compacted(*(_t(s[k]) for k in ("raypos", "raydir")), s["stepsize"],
                               _t(s["tminmax"]), *(_t(s[k]) for k in LEAVES[1:4]),
                               _t(s["template"]), **kw)
    assert int(count) > 0
    assert [r.getMessage() for r in caplog.records] == [
        f"mvp_raymarch_xla: {int(count)} rays exceeded max_samples=4; their farthest samples "
        "were dropped. Raise max_samples or use the cuda backend."]

    out_err, _ = _port_run(s, cot, False, on_overflow="error", **kw)
    assert np.isnan(out_err).all()
    with pytest.raises(ValueError, match="on_overflow"):
        _port_run(s, cot, False, on_overflow="ignore", **kw)


def test_coincident_primitives_keep_index_order():
    """Two coincident opaque primitives, red (index 0) and green (index 1):
    their samples tie in t at every step, and the first sample saturates
    the ray, so the nearer-first, lower-index-first order of a stable sort
    decides the colour: red, as in JAX."""
    n, h, w = 1, 9, 9
    px, py = np.meshgrid(np.linspace(-0.5, 0.5, w), np.linspace(-0.5, 0.5, h))
    ro = np.stack([px, py, np.full_like(px, -4.0)], -1)[None].astype(np.float32)
    rd = np.tile(np.array([0, 0, 1.0], np.float32), (n, h, w, 1))
    s = dict(raypos=ro, raydir=rd, stepsize=0.1,
             tminmax=np.tile(np.array([0.0, 8.0], np.float32), (n, h, w, 1)),
             primpos=np.zeros((n, 2, 3), np.float32),
             primrot=np.tile(np.eye(3, dtype=np.float32), (n, 2, 1, 1)),
             primscale=np.ones((n, 2, 3), np.float32),
             template=np.zeros((n, 2, 4, 4, 4, 4), np.float32))
    s["template"][:, 0, ..., 0] = 1.0
    s["template"][:, 1, ..., 1] = 1.0
    s["template"][..., 3] = 100.0
    kw = dict(fadescale=0.0, fadeexp=8.0, tile=8, max_hit=2, max_samples=64)
    cot = np.random.RandomState(7).randn(n, h, w, 4).astype(np.float32)
    ref, gref = _jax_run(s, cot, False, **kw)
    out, grads = _port_run(s, cot, False, **kw)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    _grad_close("template", grads[0], gref[0])
    # the boxes are uniform and unfaded: the geometry's gradients are zero
    # up to rounding on both sides
    for got, want in zip(grads[1:], gref[1:]):
        np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(out[..., 0], 1.0, atol=1e-6)  # every ray hits: red
    np.testing.assert_allclose(out[..., 1], 0.0, atol=1e-6)


def check_against_kernels(rep):
    """``kbench.compare_with_kernels``' numbers against this file's limits."""
    assert rep["truncated_tiles"] == 0 and rep["overflow_rays"] == 0, rep
    assert rep["alpha_beyond_1e-4"] == 0 and rep["image_beyond_1e-4_free"] == 0, rep
    for k, v in rep.items():
        if k.endswith("_cos"):
            assert v > 0.9999, (k, rep)
        if k.startswith("grad_") and k.endswith("_rel_err"):
            assert v <= 1e-3, (k, rep)


def test_xla_matches_the_kernels_plain_versions():
    """Against the CUDA op's plain versions (the kernels' arithmetic), on a
    scene where about a third of the rays saturate: there the two rules of
    compositing a step differ (the kernels add the step's densities first),
    elsewhere the two agree; the card test does the same on the kernels."""
    s = raymarch_scene(n=2, h=37, w=35, k3=3, bs=8, warp=True, seed=8)
    s["template"][..., 3] *= 1.6
    s["primrot"] = rodrigues(torch.from_numpy(s["primrvec"])).numpy()
    rep = kbench.compare_with_kernels(kbench.scene_tensors(s, "cpu"), s["stepsize"], tile=16,
                                      max_hit=27, max_samples=512, chunk_tiles=8, fadescale=6.5)
    check_against_kernels(rep)
    assert 0.3 < rep["free_share"] < 0.95
    assert rep["image_max_abs_err_saturated"] > 1e-3  # the rules differ there


def test_rays_parallel_to_a_face_keep_gradients_finite():
    """A camera beside a box: its first column of rays has no x component,
    misses the box parallel to its x faces, and puts the box's entry ~1e9
    steps away; the other rays hit it. JAX evaluates the unused samples
    there, |y|^8 overflows and its gradients in primpos, primrot and
    primscale are NaN; the port's are finite and the oracle's, and the
    output is JAX's."""
    n, h, w = 1, 8, 16
    u, v = np.meshgrid(np.linspace(0.0, 0.6, w), np.linspace(-0.15, 0.15, h))
    rd = np.stack([u, v, np.ones_like(u)], -1)[None]
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    ro = np.tile(np.array([-1.5, 0.0, -4.0], np.float32), (n, h, w, 1))
    s = dict(raypos=ro, raydir=rd, stepsize=0.1, tminmax=np.tile(np.array([0.0, 8.0], np.float32), (n, h, w, 1)),
             primpos=np.zeros((n, 1, 3), np.float32),
             primrot=np.tile(np.eye(3, dtype=np.float32), (n, 1, 1, 1)),
             primscale=np.ones((n, 1, 3), np.float32),
             template=np.random.RandomState(9).rand(n, 1, 4, 4, 4, 4).astype(np.float32))
    cot = np.ones((n, h, w, 4), np.float32)
    kw = dict(tile=8, max_hit=4, max_samples=64)
    ref, gref = _jax_run(s, cot, False, **kw)
    assert not all(np.isfinite(g).all() for g in gref[1:4])  # JAX's fault
    out, grads = _port_run(s, cot, False, **kw)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    _, goracle = _port_run(s, cot, False, march=mvp_raymarch_reference, max_steps=82)
    for name, got, want in zip(LEAVES, grads, goracle):
        assert np.isfinite(got).all(), name
        assert _cos(got, want) > 0.999, name


# ---------------------------------------------------------------------------
# the backend in the model and in the configuration
# ---------------------------------------------------------------------------

# tests/test_models.py's xla autoencoder (16x16 rays, tile 8, max_hit 8, 16
# samples, chunks of 4 tiles) with 256 primitives of 16^3 instead of 1024 of
# 8^3: on a 64^2 position map 1024 primitives take 2x2 blocks, where the JAX
# package's rotations are all zero (ROADMAP Queue 3); and a step of 16 / 256,
# so that 16 samples reach into the head
SIZES = dict(texsize=64, nprims=256, primsize=16, height=16, width=16, batch=2, nident=2,
             ncams=2)
OPTS = {"tile": 8, "max_hit": 8, "max_samples": 16, "chunk_tiles": 4, "dt": 16.0}


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    err, lim = np.abs(got - ref).max(), 1e-4 * np.abs(ref).max() + 1e-4
    assert err <= lim, f"{what}: max|d| {err:.3g} > {lim:.3g}"


def test_autoencoder_xla_backend_matches_jax():
    """The deterministic forward, with the adaptive scale set from a seed
    in both (the warm-up forward that would set it is held to JAX in
    test_torch_port_model.py)."""
    from __graft_entry__ import _build
    from ava256_tpu.train.init import init_model

    model, mb, _ = _build(raymarch_backend="xla", raymarch_options=dict(OPTS), **SIZES)
    variables = init_model(model, jax.random.PRNGKey(0), mb)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    tree["stats"]["decoder_assembler"]["adaptwarps"] = np.random.RandomState(4).uniform(
        4.0, 12.0, SIZES["nprims"]).astype(np.float32)
    ds = SyntheticDataset(nident=2, ncams=2, height=16, width=16, texsize=64)
    port = get_autoencoder(synthetic_uvdata(64), ds.vertmean, ds.vertstd, ncams=2, nident=2,
                           nprims=256, primsize=(16,) * 3, raymarch_backend="xla",
                           raymarch_options=dict(OPTS), device="cpu")
    load_flax(port, tree)
    port.eval()
    assert port.raymarcher.backend == "xla"
    batch = none_collate([ds[i] for i in range(2)])
    tb = {k: torch.from_numpy(np.asarray(batch[k])) for k in mb}
    keys = frozenset({"ialpha"})

    jout = jax.jit(lambda v, b: model.apply(
        v, target_neut_avgtex=b["neut_avgtex"], target_neut_verts=b["neut_verts"],
        idindex=b["idindex"], camindex=b["camindex"], deterministic=True, output_set=keys,
        **{n: b[n] for n in BATCH_MODEL_KEYS}))(jax.tree_util.tree_map(jnp.asarray, tree), mb)
    with torch.no_grad():
        tout = port(target_neut_avgtex=tb["neut_avgtex"], target_neut_verts=tb["neut_verts"],
                    idindex=tb["idindex"], camindex=tb["camindex"], deterministic=True,
                    output_set=keys, **{n: tb[n] for n in BATCH_MODEL_KEYS})
    assert float(tout["ialpha"].mean()) > 0.01  # the march reaches the head
    _close(tout["irgbrec"].numpy(), jout["irgbrec"], "irgbrec")
    _close(tout["ialpha"].numpy(), jout["ialpha"], "ialpha")


def test_config_backend_xla_builds_and_reaches_the_marcher():
    """model.raymarch.backend: xla builds through build_model; the YAML's
    max_samples, chunk_tiles and on_overflow reach the marcher, and the
    kernels' own keys (rows, nbuf) are dropped."""
    shrink = ["model.nprims=256", "model.primsize=16", "data.synthetic_texsize=64",
              "data.synthetic_height=16", "data.synthetic_width=16", "train.batchsize=1",
              "model.raymarch.backend=xla", "model.raymarch.tile=8",
              "model.raymarch.max_hit=16", "model.raymarch.nbuf=64", "model.raymarch.dt=16.0"]
    cfg = load_config("configs/config-synthetic.yaml", shrink)
    ds = loop.build_dataset(cfg)
    model = loop.build_model(cfg, ds, synthetic_uvdata(64), "cpu")
    rm = model.raymarcher
    assert rm.backend == "xla"
    assert {k: rm.options[k] for k in ("max_samples", "chunk_tiles", "rows")} == dict(
        max_samples=64, chunk_tiles=32, rows=8)
    b = {k: torch.from_numpy(np.asarray(v))
         for k, v in loop.to_model_batch(none_collate([ds[0]])).items()}

    def render(**options):
        rm.options.update(options)
        with torch.no_grad():
            return model(target_neut_avgtex=b["neut_avgtex"], target_neut_verts=b["neut_verts"],
                         idindex=b["idindex"], camindex=b["camindex"], running_avg_scale=True,
                         generator=torch.Generator().manual_seed(0),
                         **{k: b[k] for k in BATCH_MODEL_KEYS})["irgbrec"]

    assert torch.isfinite(render()).all()
    assert torch.isnan(render(max_samples=1, on_overflow="error")).all()
