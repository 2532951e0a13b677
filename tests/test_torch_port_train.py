# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The port's training path (ava256_tpu_torch.train, data.cond_cache,
convert.load_train_state) against the JAX package on the CPU.

- losses, schedule, NaN scrub, global-norm clip and three optimizer updates
  (adam, adamw, sgd) on a random gradient tree against optax: 1e-6;
- ``expand_batch`` against the JAX one: equal;
- one train step on the reduced model of ``tests/test_torch_port_model.py``
  (``SIZES``, ``OPTS``), with the warm-up switches and without, the JAX draw
  of the bottleneck noise fed to the port: loss terms to 1e-4 relative, every
  parameter's gradient (the JAX tree in the port's layout) to cosine > 0.9999
  and max |d| <= 1e-3 max |ref|, the ``adaptwarps`` buffer to 1e-4. The
  background MLP's gradients are compared with its leaky-relus pinned to the
  JAX side where an input is within fp32 rounding of zero (see
  ``_bg_grads_pinned``). Parameters
  after Adam's first step are not compared: that update is lr * g / (|g| +
  eps), so noise in a tiny gradient flips it; the optimizer has its own test;
- activation checkpointing changes neither gradients nor the number of
  ``adaptwarps`` updates;
- checkpoint save -> restore -> next step is bit-equal; a converted JAX
  ``TrainState`` with Adam moments takes the same next update as optax: 1e-6;
- the flagship numbers built into the port equal the yaml configuration.
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from ava256_tpu.data import cond_cache as jax_cc
from ava256_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from ava256_tpu.train import losses as jax_losses
from ava256_tpu.train import state as jax_state
from ava256_tpu.train.step import BATCH_MODEL_KEYS, make_train_step as jax_make_train_step
from ava256_tpu_torch.convert import flax_to_state_dict, load_flax, load_train_state
from ava256_tpu_torch.data import cond_cache as cc
from ava256_tpu_torch.data.synthetic import SyntheticDataset, none_collate, synthetic_uvdata
from ava256_tpu_torch.factory import get_autoencoder
from ava256_tpu_torch.flagship import FLAGSHIP
from ava256_tpu_torch.models import bg as bg_module
from ava256_tpu_torch.ops import layers
from ava256_tpu_torch.train import loop
from ava256_tpu_torch.train.losses import compute_losses
from ava256_tpu_torch.train.state import (
    Optimizer, TrainState, clip_by_global_norm, latest_checkpoint_step, make_optimizer,
    restore_checkpoint, save_checkpoint, scrub_nonfinite, step_lr_schedule)
from ava256_tpu_torch.train.step import make_eval_step, make_train_step, step_generator

from tests.test_torch_port_model import OPTS, SIZES, _perturb

LOSS_WEIGHTS = dict(FLAGSHIP["losses"])
# the test workers run side by side: a few threads each, not one per core
torch.set_num_threads(min(4, torch.get_num_threads()))


def _close(got, ref, rel, abs_=0.0, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    lim = rel * np.abs(ref).max() + abs_
    assert err <= lim, f"{what}: max|d| {err:.3g} > {lim:.3g}"


# ---------------------------------------------------------------------------
# losses, schedule, scrub, clip, optimizer
# ---------------------------------------------------------------------------


def test_losses_match_jax():
    rng = np.random.RandomState(0)
    out = dict(irgbrec=rng.rand(2, 8, 6, 3) * 255, verts=rng.randn(2, 11, 3) * 50,
               primscale=rng.rand(2, 9, 3) * 20 + 1, expr_mu=rng.randn(2, 4, 4, 16),
               expr_logstd=rng.randn(2, 4, 4, 16) * 0.1)
    batch = dict(image=rng.rand(2, 8, 6, 3) * 255, verts=rng.randn(2, 11, 3))
    out, batch = ({k: v.astype(np.float32) for k, v in d.items()} for d in (out, batch))
    vertmean = rng.randn(11, 3).astype(np.float32)
    tj, termsj = jax_losses.compute_losses(
        {k: jnp.asarray(v) for k, v in out.items()}, {k: jnp.asarray(v) for k, v in batch.items()},
        LOSS_WEIGHTS, jnp.asarray(vertmean), 13.0)
    tt, termst = compute_losses(
        {k: torch.from_numpy(v) for k, v in out.items()},
        {k: torch.from_numpy(v) for k, v in batch.items()}, LOSS_WEIGHTS,
        torch.from_numpy(vertmean), 13.0)
    assert set(termst) == set(termsj) == set(LOSS_WEIGHTS)
    for k in termsj:
        _close(termst[k].numpy(), termsj[k], 1e-6, what=k)
    _close(tt.numpy(), tj, 1e-6, what="total")
    with pytest.raises(ValueError, match="No losses"):
        compute_losses({}, {}, {}, torch.zeros(1), 1.0)


def test_schedule_scrub_and_clip_match_optax():
    sj = jax_state.step_lr_schedule(2e-4, 1.4, 5)
    st = step_lr_schedule(2e-4, 1.4, 5)
    for step in (0, 4, 5, 6, 10, 1000):
        np.testing.assert_allclose(st(step), float(sj(jnp.asarray(step))), rtol=1e-6)
    rng = np.random.RandomState(1)
    tree = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32) * 3}
    tree["a"][0, 0], tree["a"][1, 1], tree["b"][2] = np.nan, np.inf, -np.inf
    tx = optax.chain(jax_state.scrub_nonfinite(), optax.clip_by_global_norm(1.0))
    ref, _ = tx.update({k: jnp.asarray(v) for k, v in tree.items()}, tx.init(tree))
    grads = [torch.from_numpy(tree[k].copy()) for k in ("a", "b")]
    scrub_nonfinite(grads)
    assert float(grads[0][0, 0]) == 0.0 and float(grads[1][2]) == 0.0
    norm = clip_by_global_norm(grads, 1.0)
    assert float(norm) > 1.0
    for g, k in zip(grads, ("a", "b")):
        _close(g.numpy(), ref[k], 1e-6, what=k)
    # below the limit nothing moves
    small = [torch.full((3,), 0.1)]
    clip_by_global_norm(small, 1.0)
    assert torch.equal(small[0], torch.full((3,), 0.1))


@pytest.mark.parametrize("optim_type", ["adam", "adamw", "sgd"])
def test_optimizer_updates_match_optax(optim_type):
    """Three updates, the learning-rate bump between the second and third,
    the first gradient with non-finite entries and a norm above the clip."""
    rng = np.random.RandomState(2)
    shapes = {"w": (6, 4), "b": (4,), "k": (3, 3, 2, 5)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * sc).astype(np.float32) for k, s in shapes.items()}
             for sc in (5.0, 0.01, 1.0)]
    grads[0]["w"][0, 0], grads[0]["b"][1] = np.nan, np.inf
    tx = jax_state.make_optimizer(optim_type, 2e-3, 1.4, 2, 1.0)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(pj)
    pt = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = Optimizer(pt.values(), optim_type, 2e-3, 1.4, 2, 1.0)
    for step, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, pj)
        pj = optax.apply_updates(pj, updates)
        for k, p in pt.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step(step)
        for k in shapes:
            _close(pt[k].detach().numpy(), pj[k], 1e-6, what=f"{optim_type} step {step} {k}")
    assert opt.core.param_groups[0]["lr"] == pytest.approx(2e-3 * 1.4)
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        Optimizer(pt.values(), "lion")


# ---------------------------------------------------------------------------
# conditioning tables
# ---------------------------------------------------------------------------


def test_expand_batch_matches_jax():
    kw = dict(nident=3, ncams=4, nframes=2, height=24, width=20, texsize=32)
    ds, dsj = SyntheticDataset(**kw), JaxSyntheticDataset(**kw)
    tables, tables_j = ds.conditioning_tables(), dsj.conditioning_tables()
    names = cc.cached_field_names(tables)
    assert names == jax_cc.cached_field_names(tables_j)
    assert cc.table_nbytes(tables) == jax_cc.table_nbytes(tables_j) > 0
    idxs = [0, 5, 10, 17]
    full = none_collate([ds[i] for i in idxs])
    lean = none_collate([cc.LeanView(ds, names)[i] for i in idxs])
    assert not (names & set(lean)) and len(cc.LeanView(ds, names)) == len(ds)
    ref = jax_cc.expand_batch({k: jnp.asarray(v) for k, v in lean.items()}, tables_j)
    dev_tables = cc.tables_to_device(tables, "cpu")
    assert cc.table_nbytes(dev_tables) == cc.table_nbytes(tables)
    got = cc.expand_batch({k: torch.as_tensor(np.asarray(v)) for k, v in lean.items()},
                          dev_tables)
    host = cc.expand_batch_host(lean, tables)
    assert set(got) == set(ref) == set(host)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
        np.testing.assert_array_equal(host[k], np.asarray(full[k]), err_msg=k)
    tfull = {k: torch.as_tensor(np.asarray(v)) for k, v in full.items()}
    assert cc.expand_batch(tfull, None) is tfull
    assert torch.equal(cc.expand_batch(tfull, dev_tables)["avgtex"], tfull["avgtex"])


# ---------------------------------------------------------------------------
# the train step on the reduced model
# ---------------------------------------------------------------------------


def _capture_grads() -> optax.GradientTransformation:
    """Keeps the gradients as its state and updates nothing, so a JAX train
    step hands its gradients back exactly."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, updates), updates))


@pytest.fixture(scope="module")
def setup():
    from __graft_entry__ import _build
    from ava256_tpu.train.init import init_model

    model, mb, dsj = _build(raymarch_backend="pallas",
                            raymarch_options=dict(OPTS, interpret=True), **SIZES)
    variables = init_model(model, jax.random.PRNGKey(0), mb)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    tree = {"params": _perturb(tree["params"], np.random.RandomState(7)),
            "stats": tree["stats"]}
    # opacity exp(0.1 (x + slab_bias)) is about 1 at init, which saturates every
    # ray and leaves the background no gradient but rounding; about 0.3 gives
    # rays of every kind: saturated, partly covered and empty
    geodec = tree["params"]["decoder_assembler"]["geodec"]
    geodec["slab_bias"] = geodec["slab_bias"] - 12.0
    ds = SyntheticDataset(nident=SIZES["nident"], ncams=SIZES["ncams"], height=32, width=32,
                          texsize=64)
    batch_np = none_collate([ds[i] for i in range(SIZES["batch"])])
    tb = {k: torch.from_numpy(np.asarray(batch_np[k])) for k in mb}
    return model, tree, mb, dsj, ds, tb


def _port_model(ds, tree):
    port = get_autoencoder(synthetic_uvdata(64), ds.vertmean, ds.vertstd, ncams=2, nident=2,
                           nprims=256, primsize=(16,) * 3, raymarch_options=OPTS, device="cpu")
    return load_flax(port, tree)


def _port_step(ds, tree, tb, noise, flags, clip=1e30, port=None):
    port = _port_model(ds, tree) if port is None else port
    opt = make_optimizer(port, "adam", 2e-4, 1.4, 10_000, clip)
    step = make_train_step(port, opt, LOSS_WEIGHTS, ds.vertmean, ds.vertstd)
    marks = []
    state, total, terms = step(TrainState(port, opt, 0), tb, noise=noise, mark=marks.append,
                               **flags)
    assert marks == ["forward", "backward", "optimizer"] and state.step == 1
    return port, total, terms


WARMUP = dict(running_avg_scale=True, use_gt_geo=True, residuals_weight=0.0)
NORMAL = dict(running_avg_scale=False, use_gt_geo=False, residuals_weight=1.0)


@pytest.fixture(scope="module")
def warm_stats(setup):
    """The adaptwarps statistic after one warm-up forward (a normal step needs
    non-zero primitive scales)."""
    model, tree, mb, _, _, _ = setup
    jvars = jax.tree_util.tree_map(jnp.asarray, tree)
    _, mut = jax.jit(lambda v, b, k: model.apply(
        v, target_neut_avgtex=b["neut_avgtex"], target_neut_verts=b["neut_verts"],
        idindex=b["idindex"], camindex=b["camindex"], running_avg_scale=True,
        mutable=["stats"], rngs={"sample": k}, render=False,
        **{k_: b[k_] for k_ in BATCH_MODEL_KEYS}))(jvars, mb, jax.random.PRNGKey(1))
    return jax.tree_util.tree_map(np.asarray, mut["stats"])


# A pre-activation of the background MLP this close to zero is the rounding of
# its fp32 sum of up to 256 terms: the two frameworks may land on either side.
AMBIGUOUS = 5e-5


def _bg_grads_pinned(bgmodel, inputs, cotangent, ref, monkeypatch):
    """The background model's gradients under ``cotangent`` with its MLP's
    leaky-relus pinned to the side the reference took.

    Each of the 2,048 pixels carries about 1e-3 of a gradient row, so one
    pre-activation that rounds to the other side of zero moves that row of the
    layer's weight and bias gradients, and every layer below it, by about the
    tolerance. Such entries are found here and nowhere assumed: going down
    from the last hidden layer, a row of a bias gradient that is off picks,
    among its entries with |pre-activation| < AMBIGUOUS only, those whose
    other slope (a change of 0.8 x that entry's cotangent) brings it to the
    reference. The pinned gradients are then held to the full tolerance, the
    weights' rows included, which the choice never looked at.

    Returns (gradients unpinned, gradients pinned, number of pinned entries).
    """
    def run(pins):
        pre = []

        def leaky_relu(x, negative_slope=0.2):
            if x.ndim != 4:  # the embeddings' dense layers
                return layers.leaky_relu(x, negative_slope)
            flip = pins.get(len(pre))
            pre.append(x)
            x.retain_grad()
            pos = (x >= 0) if flip is None else (x >= 0) ^ flip
            return torch.where(pos, x, negative_slope * x)

        monkeypatch.setattr(bg_module, "leaky_relu", leaky_relu)
        bgmodel.zero_grad()
        bgmodel(*inputs).backward(cotangent)
        monkeypatch.undo()
        grads = {f"bgmodel.{n}": p.grad.clone() for n, p in bgmodel.named_parameters()}
        return pre, grads

    pins = {}
    _, plain = run(pins)
    for layer in (4, 3, 2, 1, 0):
        pre, grads = run(pins)
        x, dpre = pre[layer].detach(), pre[layer].grad  # [N, 256, H, W]
        name = f"bgmodel.mlp{layer}.bias"
        resid = (ref[name] - grads[name]).double()
        flip = pins.get(layer, torch.zeros_like(x, dtype=torch.bool))
        pos = (x >= 0) ^ flip
        # the change of dpre when the entry takes its other slope
        delta = torch.where(pos, dpre * (0.2 - 1.0), dpre * (1.0 / 0.2 - 1.0)).double()
        for row in torch.nonzero(resid.abs() > 1e-4 * ref[name].abs().max()).flatten().tolist():
            cand = torch.nonzero(x[:, row].abs() < AMBIGUOUS)
            cand = sorted(cand.tolist(), key=lambda c: -abs(float(delta[c[0], row, c[1], c[2]])))
            r = float(resid[row])
            for n_, h_, w_ in cand:
                d = float(delta[n_, row, h_, w_])
                if abs(r - d) < abs(r):
                    flip[n_, row, h_, w_] ^= True
                    r -= d
        pins[layer] = flip
    _, pinned = run(pins)
    return plain, pinned, int(sum(int(f.sum()) for f in pins.values()))


@pytest.mark.parametrize("phase", ["warmup", "normal"])
def test_train_step_matches_jax(setup, warm_stats, phase, monkeypatch):
    model, tree, mb, dsj, ds, tb = setup
    flags = WARMUP if phase == "warmup" else NORMAL
    if phase == "normal":
        tree = {"params": tree["params"], "stats": warm_stats}
    jvars = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = _capture_grads()
    jstep = jax_make_train_step(model, tx, LOSS_WEIGHTS, dsj.vertmean, dsj.vertstd)
    rng = jax.random.PRNGKey(3)
    # the bottleneck's draw under this key, from a forward without the march
    enc = jax.jit(lambda v, b, k: model.apply(
        v, target_neut_avgtex=b["neut_avgtex"], target_neut_verts=b["neut_verts"],
        idindex=b["idindex"], camindex=b["camindex"], rngs={"sample": k}, render=False,
        **{k_: b[k_] for k_ in BATCH_MODEL_KEYS}))(jvars, mb, rng)
    noise = (np.asarray(enc["encoding"]) - np.asarray(enc["expr_mu"])) / np.exp(
        np.asarray(enc["expr_logstd"]))
    jstate = jax_state.create_train_state(jvars, tx)
    jnew, jtotal, jterms = jstep(jstate, mb, rng, **flags)
    jgrads = jax.tree_util.tree_map(np.asarray, jnew.opt_state)
    jstats = jax.tree_util.tree_map(np.asarray, jnew.stats)

    port = _port_model(ds, tree)
    bg_before = copy.deepcopy(port.bgmodel)  # the step moves the parameters
    bg_io = {}

    def keep_bg(module, inputs, output):
        bg_io["inputs"] = tuple(x.detach() for x in inputs)
        if output.requires_grad:
            output.register_hook(lambda g: bg_io.__setitem__("cotangent", g))

    hook = port.bgmodel.register_forward_hook(keep_bg)
    port, total, terms = _port_step(ds, tree, tb, torch.from_numpy(noise), flags, port=port)
    hook.remove()
    assert set(terms) == set(jterms)
    for k in jterms:
        _close(terms[k].numpy(), jterms[k], 1e-4, 1e-7, what=k)
    _close(total.numpy(), jtotal, 1e-4, what="total")
    _close(port.decoder_assembler.adaptwarps.numpy(),
           jstats["decoder_assembler"]["adaptwarps"], 1e-4, 1e-4, "adaptwarps")
    ref = flax_to_state_dict({"params": jgrads, "stats": jstats}, port)
    step_grads = {name: p.grad for name, p in port.named_parameters()}
    bg_plain, bg_pinned, npinned = _bg_grads_pinned(
        bg_before, bg_io["inputs"], bg_io["cotangent"], ref, monkeypatch)
    for name, g in bg_plain.items():  # the background alone repeats the step's gradients
        _close(g.numpy(), step_grads[name].numpy(), 1e-6, what=name)
    assert npinned <= 16, npinned
    checked, bad = 0, []
    for name, p in port.named_parameters():
        # a parameter the step does not reach has no gradient here, zeros in JAX
        grad = torch.zeros_like(p) if step_grads[name] is None else step_grads[name]
        grad = bg_pinned.get(name, grad)
        a, b = ref[name].numpy().astype(np.float64), grad.numpy().astype(np.float64)
        assert np.isfinite(b).all(), name
        if np.abs(a).max() == 0.0:
            assert np.abs(b).max() == 0.0, name
            continue
        dp = (a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum() + 1e-300)
        err = np.abs(a - b).max() / np.abs(a).max()
        if not (dp > 0.9999 and err <= 1e-3):
            bad.append(f"{name}: dp={dp}, max|d|/max|ref|={err}")
        checked += 1
    assert not bad, bad
    assert checked > 50
    # the decoders that feed the march take a gradient from it
    for name in ("decoder_assembler.rgbdec", "decoder_assembler.geodec"):
        sub = port.get_submodule(name)
        assert any(p.grad is not None and float(p.grad.abs().max()) > 0
                   for p in sub.parameters()), name


def test_remat_changes_nothing(setup, warm_stats):
    """With and without activation checkpointing: the same loss, the same
    gradients, and one adaptwarps update per step."""
    _, tree, _, _, ds, tb = setup
    tree = {"params": tree["params"], "stats": warm_stats}
    noise = torch.from_numpy(np.random.RandomState(4).randn(2, 4, 4, 16).astype(np.float32))
    flags = dict(running_avg_scale=True, use_gt_geo=False, residuals_weight=1.0)
    results = []
    for remat in (True, False):
        layers.REMAT = remat
        try:
            port, total, _ = _port_step(ds, tree, tb, noise, flags)
        finally:
            layers.REMAT = True
        results.append((port, float(total)))
    (a, ta), (b, tb_) = results
    assert ta == pytest.approx(tb_, rel=1e-6)
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert (p.grad is None) == (q.grad is None), name
        if p.grad is not None:
            _close(p.grad.numpy(), q.grad.numpy(), 1e-5, 1e-12, what=name)
    # one EMA step from the warm statistic, not two
    with torch.no_grad():
        once = _port_model(ds, tree)
        once(target_neut_avgtex=tb["neut_avgtex"], target_neut_verts=tb["neut_verts"],
             idindex=tb["idindex"], camindex=tb["camindex"], running_avg_scale=True,
             noise=noise, render=False, **{k: tb[k] for k in BATCH_MODEL_KEYS})
    old = torch.from_numpy(np.array(warm_stats["decoder_assembler"]["adaptwarps"]))
    assert not torch.equal(once.decoder_assembler.adaptwarps, old)
    for m in (a, b):
        _close(m.decoder_assembler.adaptwarps.numpy(), once.decoder_assembler.adaptwarps.numpy(),
               1e-6, what="adaptwarps")


def test_checkpoint_roundtrip_and_resume(setup, warm_stats, tmp_path):
    """save -> restore into a fresh state -> the next step is bit-equal; the
    step's own generator makes a resumed run replay."""
    _, tree, _, _, ds, tb = setup
    tree = {"params": tree["params"], "stats": warm_stats}

    def fresh(seed_tree):
        port = _port_model(ds, seed_tree)
        opt = make_optimizer(port, "adam", 2e-4, 1.4, 10_000, 1.0)
        return TrainState(port, opt, 0), make_train_step(port, opt, LOSS_WEIGHTS, ds.vertmean,
                                                         ds.vertstd)

    state, step = fresh(tree)
    state, _, _ = step(state, tb, **NORMAL)
    assert latest_checkpoint_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path, state)
    path = save_checkpoint(tmp_path, state)
    assert path.name == "step_00000001.pt" and latest_checkpoint_step(tmp_path) == 1
    assert not list(tmp_path.glob("*.tmp"))
    state, total_a, terms_a = step(state, tb, **NORMAL)

    other, step_b = fresh({"params": _perturb(tree["params"], np.random.RandomState(9)),
                           "stats": tree["stats"]})
    other = restore_checkpoint(tmp_path, other)
    assert other.step == 1
    other, total_b, terms_b = step_b(other, tb, **NORMAL)
    assert torch.equal(total_a, total_b) and other.step == state.step == 2
    for k in terms_a:
        assert torch.equal(terms_a[k], terms_b[k]), k
    sa, sb = state.model.state_dict(), other.model.state_dict()
    assert set(sa) == set(sb) and "decoder_assembler.adaptwarps" in sa
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    g1, g2 = step_generator("cpu", 5), step_generator("cpu", 5)
    assert torch.equal(torch.randn(4, generator=g1), torch.randn(4, generator=g2))
    assert not torch.equal(torch.randn(4, generator=step_generator("cpu", 6)),
                           torch.randn(4, generator=step_generator("cpu", 5)))
    # the deterministic eval forward
    out = make_eval_step(state.model)(tb, tb["neut_avgtex"], tb["neut_verts"])
    assert out["irgbrec"].shape == (2, 32, 32, 3) and bool(torch.isfinite(out["irgbrec"]).all())


@pytest.mark.parametrize("optim_type", ["adam", "sgd"])
def test_converted_train_state_continues_like_optax(setup, optim_type):
    """A JAX TrainState after two optimizer steps (moments, count, step), as
    numpy trees -> the port's state; both then take the same third update."""
    _, tree, _, _, ds, _ = setup
    rng = np.random.RandomState(11)
    params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    tx = jax_state.make_optimizer(optim_type, 2e-4, 1.4, 10_000, 1.0)
    jstate = jax_state.create_train_state({"params": params, "stats": tree["stats"]}, tx)

    def random_grads(scale):
        return jax.tree_util.tree_map(
            lambda x: jnp.asarray((rng.randn(*x.shape) * scale).astype(np.float32)), params)

    @jax.jit
    def apply(state, grads):
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        return jax_state.TrainState(params=optax.apply_updates(state.params, updates),
                                    stats=state.stats, opt_state=opt_state, step=state.step + 1)

    for scale in (0.01, 1e-4):
        jstate = apply(jstate, random_grads(scale))
    as_numpy = jax.tree_util.tree_map(np.asarray, jstate.as_dict())

    port = get_autoencoder(synthetic_uvdata(64), ds.vertmean, ds.vertstd, ncams=2, nident=2,
                           nprims=256, primsize=(16,) * 3, raymarch_options=OPTS, device="cpu")
    state = TrainState(port, make_optimizer(port, optim_type, 2e-4, 1.4, 10_000, 1.0), 0)
    state = load_train_state(state, as_numpy)
    assert state.step == 2
    third = random_grads(1e-3)
    jstate = apply(jstate, third)
    gsd = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, third),
                              "stats": tree["stats"]}, port)
    for name, p in port.named_parameters():
        p.grad = gsd[name].clone()
    state.optimizer.step(state.step)
    ref = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jstate.params),
                              "stats": tree["stats"]}, port)
    before = flax_to_state_dict({"params": as_numpy["params"], "stats": tree["stats"]}, port)
    for name, p in port.named_parameters():
        _close(p.detach().numpy(), ref[name].numpy(), 1e-6, 1e-9, what=name)
        # and the update itself, not only the parameter it is added to (the
        # difference of two fp32 parameters carries their last-bit rounding)
        _close((p.detach() - before[name]).numpy(), (ref[name] - before[name]).numpy(),
               1e-3, 1e-6, what=f"update of {name}")
    with pytest.raises(KeyError):
        load_train_state(state, dict(as_numpy, opt_state=()))


# ---------------------------------------------------------------------------
# the loop and the built-in configuration
# ---------------------------------------------------------------------------


def test_flagship_numbers_equal_yaml():
    import yaml

    with open("configs/config-synthetic-flagship.yaml") as f:
        y = yaml.safe_load(f)
    f_ = FLAGSHIP
    tr, mo, da = y["train"], y["model"], y["data"]
    assert (f_["nident"], f_["batch"], f_["maxiter"]) == (tr["nids"], tr["batchsize"],
                                                          tr["maxiter"])
    assert (f_["lr"], f_["gamma"], f_["lr_scheduler_iter"], f_["clip"]) == (
        tr["init_learning_rate"], tr["gamma"], tr["lr_scheduler_iter"], tr["clip"])
    assert (f_["optimizer"], f_["warmup_iters"]) == (tr["optimizer"], tr["warmup_iters"])
    assert dict(f_["losses"]) == tr["losses"] and list(f_["output_set"]) == tr["output_set"]
    assert (f_["nprims"], f_["primsize"], f_["volradius"], f_["colorcal"], f_["bgmodel"]) == (
        mo["nprims"], mo["primsize"], mo["volradius"], mo["colorcal"], mo["bgmodel"])
    assert (f_["tile"], f_["max_hit"]) == (mo["raymarch"]["tile"], mo["raymarch"]["max_hit"])
    assert (f_["texsize"], f_["height"], f_["width"], f_["ncams"], f_["nframes"],
            f_["holdout_cameras"]) == (
        da["synthetic_texsize"], da["synthetic_height"], da["synthetic_width"],
        da["synthetic_cams"], da["synthetic_frames"], da["holdout_cameras"])
    import chip_smoke

    assert chip_smoke.FLAGSHIP is FLAGSHIP


def test_loop_trains_checkpoints_and_resumes(tmp_path, caplog):
    """The loop on a tiny configuration: warm-up switches for the first steps,
    a loss line per step with the learning rate, checkpoints at the cadence
    and at the end, and a second run that resumes where the first stopped."""
    import logging

    cfg = dict(FLAGSHIP, nident=2, ncams=2, nframes=2, height=16, width=16, texsize=64,
               nprims=256, primsize=16, batch=2, tile=8, max_hit=16, warmup_iters=1,
               lr_scheduler_iter=2, raymarch_options={"nbuf": 32})
    assert loop.checkpoint_cadence(0, None) == 2000 and loop.checkpoint_cadence(10_000, None) \
        == 20_000 and loop.checkpoint_cadence(5, 3) == 3
    with caplog.at_level(logging.INFO, logger="ava256_tpu_torch.train"):
        state = loop.run(cfg, out=str(tmp_path), steps=2, device="cpu", checkpoint_every=1)
    assert state.step == 2
    ckpts = sorted(p.name for p in (tmp_path / "checkpoints").glob("step_*.pt"))
    assert ckpts == ["step_00000002.pt"]
    lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith("Iteration")]
    assert len(lines) == 2 and "lr = 2.00e-04" in lines[0] and "irgbl1 = " in lines[0]
    assert float(state.model.decoder_assembler.adaptwarps.min()) > 0
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="ava256_tpu_torch.train"):
        state = loop.run(cfg, out=str(tmp_path), steps=3, device="cpu", checkpoint_every=0)
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("Resumed from") and "step 2" in m for m in msgs)
    lines = [m for m in msgs if m.startswith("Iteration")]
    assert len(lines) == 1 and lines[0].startswith("Iteration 2 ") and "lr = 2.80e-04" in lines[0]
    assert state.step == 3 and latest_checkpoint_step(tmp_path / "checkpoints") == 3
    for p in state.model.parameters():
        assert bool(torch.isfinite(p).all())


def test_loop_batches_order_resume_and_bounded_retry():
    """A run resumed at step k draws the batches a run from 0 draws from k on;
    positions whose items all fail are passed over; a dataset that yields
    nothing raises instead of spinning."""
    class Items:
        def __init__(self, bad):
            self.bad = bad

        def __len__(self):
            return 12

        def __getitem__(self, i):
            return None if i in self.bad else {"i": np.array(i)}

    def take(it, n):
        return [next(it)["i"].tolist() for _ in range(n)]

    ds = Items(bad=())
    full = take(loop.batches(ds, 4, 0, seed=5), 7)  # three per epoch
    assert sorted(sum(full[:3], [])) == list(range(12)) == sorted(sum(full[3:6], []))
    assert full[:3] != full[3:6]
    assert take(loop.batches(ds, 4, 2, seed=5), 5) == full[2:]
    order = np.random.RandomState(5).permutation(12)
    holes = take(loop.batches(Items(bad=set(order[:4].tolist())), 4, 0, seed=5), 2)
    assert holes == full[1:3]
    with pytest.raises(RuntimeError, match="no item"):
        next(loop.batches(Items(bad=set(range(12))), 4, 0))
