# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The port's models (ava256_tpu_torch.models) against the JAX package on
the CPU, with the JAX weights converted by ``ava256_tpu_torch.convert``.

One reduced model of ``__graft_entry__._build`` serves every test: 64^2
textures, 256 primitives (the adaptive-scale branch, as the flagship's
16384), 32x32 rays, tile 8, max_hit 16, 64 step rows of 16 / 256. Primitives are 16^3: the
decoder towers need sqrt(nprims) * primsize in {256, 512, 1024}. Its
random init is perturbed with seeded numpy noise first, so that zero biases
and unit colour gains are not what the comparison rests on.

- each model module: 1e-4 relative (fp32 on both sides; convs and sums run
  in another order);
- the whole slice: ``Autoencoder`` forward against the JAX ``"pallas"``
  backend in interpret mode, once with ``running_avg_scale=True`` (sampled
  bottleneck, the JAX draw fed to the port) and once ``deterministic``:
  irgbrec, verts and the adaptwarps buffer to max|d| <= 1e-4 max|ref| + 1e-4.
"""

import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ava256_tpu.train.step import BATCH_MODEL_KEYS
from ava256_tpu_torch.convert import flax_to_state_dict, load_flax
from ava256_tpu_torch.data.synthetic import SyntheticDataset, none_collate, synthetic_uvdata
from ava256_tpu_torch.factory import get_autoencoder
from ava256_tpu_torch.models.bottleneck import kl_loss_stable
from ava256_tpu_torch.render import decode

# dt 16 / volradius 256 with 64 rows spans 4 units: past the cube's diagonal,
# so the march reaches the head (at dt 1 and 32 rows it would end in front)
OPTS = {"tile": 8, "max_hit": 16, "nbuf": 64, "dt": 16.0}
SIZES = dict(texsize=64, nprims=256, height=32, width=32, batch=2, nident=2, ncams=2,
             primsize=16)


def _close(got, ref, rel, abs_=0.0, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    lim = rel * np.abs(ref).max() + abs_
    assert err <= lim, f"{what}: max|d| {err:.3g} > {lim:.3g}"


def _perturb(tree, rng):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng) for k, v in sorted(tree.items())}
    x = np.asarray(tree)
    return (x + 0.05 * (np.abs(x).mean() + 0.1) * rng.randn(*x.shape)).astype(x.dtype)


@pytest.fixture(scope="module")
def setup():
    from __graft_entry__ import _build
    from ava256_tpu.train.init import init_model

    model, mb, _ = _build(raymarch_backend="pallas",
                          raymarch_options=dict(OPTS, interpret=True), **SIZES)
    variables = init_model(model, jax.random.PRNGKey(0), mb)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    tree = {"params": _perturb(tree["params"], np.random.RandomState(7)),
            "stats": tree["stats"]}
    jvars = jax.tree_util.tree_map(jnp.asarray, tree)

    ds = SyntheticDataset(nident=SIZES["nident"], ncams=SIZES["ncams"], height=32, width=32,
                          texsize=64)
    port = get_autoencoder(synthetic_uvdata(64), ds.vertmean, ds.vertstd, ncams=2, nident=2,
                           nprims=256, primsize=(16,) * 3, raymarch_options=OPTS,
                           device="cpu")
    load_flax(port, tree)
    port.eval()
    batch_np = none_collate([ds[i] for i in range(SIZES["batch"])])
    tb = {k: torch.from_numpy(np.asarray(batch_np[k])) for k in mb}
    return model, jvars, mb, port, tb


def _jax_forward(model, jvars, mb, **kw):
    return model.apply(jvars, target_neut_avgtex=mb["neut_avgtex"],
                       target_neut_verts=mb["neut_verts"], idindex=mb["idindex"],
                       camindex=mb["camindex"], **{k: mb[k] for k in BATCH_MODEL_KEYS}, **kw)


def _port_forward(port, tb, **kw):
    with torch.no_grad():
        return port(target_neut_avgtex=tb["neut_avgtex"], target_neut_verts=tb["neut_verts"],
                    idindex=tb["idindex"], camindex=tb["camindex"],
                    **{k: tb[k] for k in BATCH_MODEL_KEYS}, **kw)


def test_slice_matches_jax(setup):
    model, jvars, mb, port, tb = setup
    port.decoder_assembler.adaptwarps.zero_()
    # 1) the warm-up forward: sampled bottleneck, adaptwarps EMA update
    # jitted: one compile of the whole forward instead of one per eager op
    jout, mut = jax.jit(lambda v, b, k: _jax_forward(
        model, v, b, running_avg_scale=True, mutable=["stats"], rngs={"sample": k}))(
            jvars, mb, jax.random.PRNGKey(3))
    noise = (np.asarray(jout["encoding"]) - np.asarray(jout["expr_mu"])) / np.exp(
        np.asarray(jout["expr_logstd"]))
    tout = _port_forward(port, tb, running_avg_scale=True, noise=torch.from_numpy(noise))
    aw_j = np.asarray(mut["stats"]["decoder_assembler"]["adaptwarps"])
    aw_t = port.decoder_assembler.adaptwarps.numpy()
    assert aw_j.max() > 0
    _close(aw_t, aw_j, 1e-4, 1e-4, "adaptwarps")
    for key in ("irgbrec", "verts"):
        _close(tout[key].numpy(), jout[key], 1e-4, 1e-4, key)

    # 2) a render with the updated stats: deterministic (z = mu)
    jvars2 = {"params": jvars["params"], "stats": mut["stats"]}
    jout = jax.jit(lambda v, b: _jax_forward(model, v, b, deterministic=True))(jvars2, mb)
    tout = _port_forward(port, tb, deterministic=True)
    irgb = np.asarray(jout["irgbrec"])
    assert np.isfinite(irgb).all() and irgb.std() > 1.0
    for key in ("irgbrec", "verts"):
        _close(tout[key].numpy(), jout[key], 1e-4, 1e-4, key)
    # the render helper is this deterministic forward
    frames = decode(port, tb, tb["neut_avgtex"], tb["neut_verts"])
    np.testing.assert_array_equal(frames.numpy(), tout["irgbrec"].numpy())


def _t(x):
    return torch.from_numpy(np.array(x))


def _modules_io(m, mb, img, sc):
    """Every model module of the JAX autoencoder on the slice's batch (run
    inside ``model.apply``)."""
    id_cond = m.identity_encoder(mb["neut_verts"], mb["neut_avgtex"])
    expr = m.expression_encoder(verts=mb["verts"], avgtex=mb["avgtex"],
                                neut_verts=mb["neut_verts"], neut_avgtex=mb["neut_avgtex"])
    z, mu, logstd = m.bottleneck(expr)
    view = mb["campos"] / jnp.linalg.norm(mb["campos"], axis=1, keepdims=True)
    da = m.decoder_assembler
    return dict(
        id_cond=id_cond, expr=expr, z=z, mu=mu, logstd=logstd,
        geo=da.geodec(mu, id_cond["z_geo"], id_cond["b_geo"]),
        rgb=da.rgbdec(mu, id_cond["z_tex"], id_cond["b_tex"], view),
        dec=da(id_cond, mu, mb["campos"], running_avg_scale=True),
        colorcal=m.colorcal(img, mb["camindex"], mb["idindex"]),
        bg=m.bgmodel(mb["camindex"], mb["idindex"], sc))


@pytest.fixture(scope="module")
def jax_io(setup):
    """The JAX modules' outputs (one jitted program) and their inputs."""
    model, jvars, mb, _, _ = setup
    rng = np.random.RandomState(2)
    img = rng.rand(2, 32, 32, 3).astype(np.float32) * 255
    sc = rng.uniform(-1, 1, (2, 32, 32, 2)).astype(np.float32)
    out, mut = jax.jit(lambda v, b, k: model.apply(
        v, b, img, sc, method=_modules_io, mutable=["stats"], rngs={"sample": k}))(
            jvars, mb, jax.random.PRNGKey(5))
    out = jax.tree_util.tree_map(np.asarray, out)
    out["adaptwarps"] = np.asarray(mut["stats"]["decoder_assembler"]["adaptwarps"])
    return out, img, sc


def test_encoders_match_jax(setup, jax_io):
    port, tb = setup[3:]
    j = jax_io[0]
    with torch.no_grad():
        t_id = port.identity_encoder(tb["neut_verts"], tb["neut_avgtex"])
        t_expr = port.expression_encoder(verts=tb["verts"], avgtex=tb["avgtex"],
                                         neut_verts=tb["neut_verts"],
                                         neut_avgtex=tb["neut_avgtex"])
    _close(t_expr.numpy(), j["expr"], 1e-4, what="expression code")
    for k in ("z_geo", "z_tex"):
        _close(t_id[k].numpy(), j["id_cond"][k], 1e-4, what=k)
    for k in ("b_geo", "b_tex"):
        assert len(t_id[k]) == len(j["id_cond"][k])
        for lvl, (a, b) in enumerate(zip(t_id[k], j["id_cond"][k])):
            _close(a.numpy(), b, 1e-4, what=f"{k}[{lvl}]")


def test_bottleneck_matches_jax(setup, jax_io):
    port = setup[3]
    j = jax_io[0]
    expr = _t(j["expr"])
    noise = (j["z"] - j["mu"]) / np.exp(j["logstd"])
    with torch.no_grad():
        tz, tmu, tls = port.bottleneck(expr, noise=_t(noise))
        dz, dmu, _ = port.bottleneck(expr, deterministic=True)
        a = port.bottleneck(expr, generator=torch.Generator().manual_seed(0))[0]
        b = port.bottleneck(expr, generator=torch.Generator().manual_seed(0))[0]
    for name, got, ref in (("z", tz, j["z"]), ("mu", tmu, j["mu"]),
                           ("logstd", tls, j["logstd"])):
        _close(got.numpy(), ref, 1e-4, what=name)
    np.testing.assert_array_equal(dz.numpy(), dmu.numpy())
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not torch.equal(a, dz)
    from ava256_tpu.models.bottleneck import kl_loss_stable as jax_kl
    _close(kl_loss_stable(tmu, tls).numpy(), jax_kl(j["mu"], j["logstd"]), 1e-4, 1e-7,
           what="kl")


def test_decoders_match_jax(setup, jax_io):
    mb, port = setup[2], setup[3]
    j = jax_io[0]
    t_id = {k: ([_t(x) for x in v] if isinstance(v, list) else _t(v))
            for k, v in j["id_cond"].items()}
    code, campos = _t(j["mu"]), _t(mb["campos"])
    view = campos / torch.linalg.norm(campos, dim=1, keepdim=True)
    tda = port.decoder_assembler
    tda.adaptwarps.zero_()
    with torch.no_grad():
        geo_t = tda.geodec(code, t_id["z_geo"], t_id["b_geo"])
        rgb_t = tda.rgbdec(code, t_id["z_tex"], t_id["b_tex"], view)
        dec_t = tda(t_id, code, campos, running_avg_scale=True)
    names = ("opacity", "geo", "primposresid", "primrvecresid", "primscaleresid")
    for name, a, b in zip(names, geo_t, j["geo"]):
        _close(a.numpy(), b, 1e-4, what=name)
    _close(rgb_t.numpy(), j["rgb"], 1e-4, what="rgb boxes")
    for k in ("verts", "template", "primpos", "primrot", "primscale"):
        _close(dec_t[k].numpy(), j["dec"][k], 1e-4, what=k)
    _close(tda.adaptwarps.numpy(), j["adaptwarps"], 1e-4, what="adaptwarps")
    # a second step of the EMA moves the buffer: 0.9 old + 0.1 new
    first = tda.adaptwarps.clone()
    with torch.no_grad():
        tda(t_id, code, campos * 0.5, running_avg_scale=True, gt_geo=_t(mb["verts"]))
    assert not torch.equal(tda.adaptwarps, first)


def test_colorcal_and_bg_match_jax(setup, jax_io):
    port, tb = setup[3:]
    j, img, sc = jax_io
    with torch.no_grad():
        cc_t = port.colorcal(_t(img), tb["camindex"], tb["idindex"])
        bg_t = port.bgmodel(tb["camindex"], tb["idindex"], _t(sc))
    _close(cc_t.numpy(), j["colorcal"], 1e-4, what="colorcal")
    _close(bg_t.numpy(), j["bg"], 1e-4, what="bg")


def test_convert_rejects_mismatched_trees(setup):
    _, jvars, _, port, _ = setup
    tree = jax.tree_util.tree_map(np.asarray, jvars)
    sd = flax_to_state_dict(tree, port)
    assert set(sd) == set(port.state_dict())
    extra = {"params": dict(tree["params"], stray={"weight": np.zeros(3)}),
             "stats": tree["stats"]}
    with pytest.raises(KeyError, match="stray"):
        flax_to_state_dict(extra, port)
    missing = {"params": {k: v for k, v in tree["params"].items() if k != "colorcal"},
               "stats": tree["stats"]}
    with pytest.raises(KeyError, match="colorcal"):
        flax_to_state_dict(missing, port)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-only refusal cannot be shown")
    ds = SyntheticDataset(nident=1, ncams=1, height=8, width=8, texsize=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_autoencoder(synthetic_uvdata(64), ds.vertmean, ds.vertstd, 1, 1, nprims=256,
                        primsize=(16,) * 3)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['ava256_tpu'] = None\n"
        "sys.modules['optax'] = None\n"
        "sys.modules['orbax'] = None\n"
        "import ava256_tpu_torch, ava256_tpu_torch.ops, ava256_tpu_torch.models\n"
        "import ava256_tpu_torch.factory, ava256_tpu_torch.convert, ava256_tpu_torch.render\n"
        "import ava256_tpu_torch.data, ava256_tpu_torch.ops.cuda_lib\n"
        "import ava256_tpu_torch.data.cond_cache, ava256_tpu_torch.flagship\n"
        "import ava256_tpu_torch.train.losses, ava256_tpu_torch.train.state\n"
        "import ava256_tpu_torch.train.step, ava256_tpu_torch.train.loop\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'ava256_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
