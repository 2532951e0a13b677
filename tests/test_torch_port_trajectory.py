# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Training trajectories of the port against the JAX package on identical
inputs: the same ``SyntheticDataset``, the same ``write_topology_obj`` mesh
and UV maps, the same batch order (``ShardedLoader``'s shuffle of (seed,
epoch)), the same warm-up switches, losses, optimizer, learning rate and
clip as the configuration, and the same bottleneck noise every step: the
JAX draw under ``fold_in(PRNGKey(0), step)`` (``train.py``'s step key),
handed to the port's step through ``noise=``.

Arms:
- ``J``: the JAX package from ``init_model`` (``PRNGKey(0)``), stepped by
  its own ``make_train_step``;
- ``P-J``: the port from J's initial weights, converted;
- ``P-own``: the port from ``get_autoencoder(seed=0)``;
- ``P-J-ulp``: P-J with one weight of ``bottleneck.mu`` moved by one unit
  in the last place, and ``P-J-ulps``: P-J with every parameter moved by
  one ulp; the measure of how fast two trajectories that agree to rounding
  part. One weight is too small a change at the tier-1 size (it parts the
  KL term by about 6e-10 in 10 steps, a 300th of the two packages'); every
  weight's ulp parts the runs as fast as the packages' own rounding does.

Logged every step, one JSON line per arm and step: every loss term, the
bottleneck's mean and largest |mu| and mean logstd, the clip's scale factor
(min(1, clip / global norm)) and the global gradient norm (non-finite
entries scrubbed, before the clip) of the expression encoder,
``bottleneck.mu``, ``bottleneck.logstd``, the decoders and the rest, with
each group's count of non-finite gradient entries.

The tier-1 test runs J, P-J and P-J-ulps at a tiny size (2 identities,
64^2 textures, 256 primitives, 32x32 rays; the kernels' path of both
packages: JAX's Pallas kernels interpreted, the port's kernels' plain
versions) for ``STEPS`` warm-up steps:
- the first ``EXACT_STEPS`` steps: every loss term of P-J equals J's to
  ``EXACT_REL`` relative;
- every step, and the median of each term over the last ``WINDOW`` steps:
  |P-J - J| within ``ULP_FACTOR`` times the largest |P-J-ulps - P-J| so far
  (how far the 1-ulp twin has parted by then) plus ``EXACT_REL`` of the term
  (plus ``KL_ABS`` for the KL term), since a port that computes what JAX
  computes parts from it no faster than from itself. Measured at this size:
  ``docs/port_r12/cpu_tiny/``, ``python docs/port_r12/summarize.py``.

The long mode runs the arms at the flagship's widths
(``configs/config-synthetic-flagship.yaml``: texsize 1024, 16,384
primitives of 8^3, batch 4) with only the render cut (64x64 rays, 4 cameras
of which 2 are held out, 8 frames), one process per arm. JAX marches with
its Pallas kernels (interpreted; ``--jax-backend``): its compacted marcher
gives NaN geometric gradients at these widths, which the warm-up's residual
ramp (x 0) spreads over its geometry decoder, bottleneck and encoders. The
port's arms take the configuration's marcher, the compacted one (its
kernels' plain versions take minutes a step here)::

    python tests/test_torch_port_trajectory.py OUT --steps 80 --arms J,P-J,P-own
        [--save-at 18,22,26,30] [--threads N] [--jax-backend pallas] [OVERRIDES...]
    python tests/test_torch_port_trajectory.py OUT --table 0,10,18,30,80

Each arm writes ``OUT/<arm>.jsonl``; J also writes its parameters, optimizer
state, statistics, batch and noise before each step of ``--save-at`` to
``OUT/J_state_<step>.pkl``. ``--trained-step OUT/J_state_<step>.pkl`` takes
one step from such a state in both packages and prints their comparison
(``tests/test_torch_port_trained_step.py`` does the same at a tiny size).
"""

import argparse
import json
import os
import pickle
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ava256_tpu_torch.config import load_config  # noqa: E402
from ava256_tpu_torch.convert import flax_to_state_dict, load_flax  # noqa: E402
from ava256_tpu_torch.data.synthetic import none_collate, write_topology_obj  # noqa: E402
from ava256_tpu_torch.geometry import create_uv_baridx  # noqa: E402
from ava256_tpu_torch.train import loop  # noqa: E402
from ava256_tpu_torch.train.state import TrainState, make_optimizer  # noqa: E402
from ava256_tpu_torch.train.step import make_train_step  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tests import _torch_port_threads  # noqa: E402,F401
from ava256_tpu.factory import get_autoencoder as jax_get_autoencoder  # noqa: E402
from ava256_tpu.geometry import create_uv_baridx as jax_create_uv_baridx  # noqa: E402
from ava256_tpu.train import state as jax_state  # noqa: E402
from ava256_tpu.train.init import init_model  # noqa: E402
from ava256_tpu.train.step import make_train_step as jax_make_train_step  # noqa: E402

CONFIG = os.path.join(ROOT, "configs", "config-synthetic-flagship.yaml")
# the long mode: the flagship's widths, only the render cut
LONG = ["data.synthetic_height=64", "data.synthetic_width=64", "data.synthetic_cams=4",
        "data.synthetic_frames=8", "model.raymarch.backend=xla"]
# the tier-1 size, on the kernels' path of both packages: JAX's Pallas kernels
# interpreted, the port's kernels' plain versions
TINY = ["train.nids=2", "train.batchsize=2", "data.synthetic_texsize=64",
        "data.synthetic_height=32", "data.synthetic_width=32", "data.synthetic_cams=4",
        "data.synthetic_frames=4", "model.nprims=256", "model.primsize=16",
        "model.raymarch.backend=pallas", "model.raymarch.tile=8", "model.raymarch.max_hit=16",
        "model.raymarch.nbuf=64", "model.raymarch.dt=16.0"]
# the compacted marcher's options, the keys both packages take
XLA_OPTIONS = ("tile", "max_hit", "max_samples", "chunk_tiles")
GROUPS = ("expression_encoder", "bottleneck.mu", "bottleneck.logstd", "decoder_assembler",
          "rest")
TERMS = ("irgbl1", "vertl1", "kldiv", "primvolsum")


# ---------------------------------------------------------------------------
# identical inputs
# ---------------------------------------------------------------------------


class Inputs:
    """The configuration, the dataset (without its held-out cameras), the
    topology's UV maps in both packages and the batch of every step."""

    def __init__(self, workdir, overrides, jax_backend=None):
        workdir = Path(workdir)
        self.cfg = cfg = load_config(CONFIG, list(overrides) + [f"assets={workdir / 'assets'}"])
        obj = write_topology_obj(workdir / "assets" / "face_topology.obj")
        res = int(cfg.data.synthetic_texsize)
        self.uv_port = create_uv_baridx(str(obj), resolution=res,
                                        cache_dir=str(workdir / "cache"))
        self.uv_jax = jax_create_uv_baridx(str(obj), resolution=res,
                                           cache_dir=str(workdir / "cache_jax"))
        self.dataset = loop.build_dataset(cfg)
        self.loader = loop.ShardedLoader(self.dataset, batch_size=cfg.train.batchsize,
                                         shuffle=True, num_workers=1)
        self.warmup = int(cfg.train.get("warmup_iters", 100))
        self.losses = dict(cfg.train.losses)
        self.output_set = frozenset(cfg.train.output_set)
        rm = dict(cfg.model.raymarch)
        self.jax_backend = jax_backend or rm.pop("backend")
        rm.pop("backend", None)
        # JAX's compacted marcher takes only its own options
        self.jax_rm = {k: v for k, v in rm.items()
                       if self.jax_backend != "xla" or k in XLA_OPTIONS}
        self._batches = {}

    def batch(self, step):
        """Step ``step``'s batch as numpy arrays: batch ``step % len`` of epoch
        ``step // len`` of the loader, as ``train.loop`` draws them."""
        if step not in self._batches:
            per = len(self.loader)
            self.loader.epoch = step // per
            idx = self.loader._epoch_indices()[(step % per) * self.loader.batch_size:][
                :self.loader.batch_size]
            b = none_collate([self.dataset[int(i)] for i in idx])
            self._batches[step] = loop.to_model_batch(b)
        return self._batches[step]

    def first(self):
        """The batch ``train.py`` initializes the JAX model from."""
        bs = self.cfg.train.batchsize
        return loop.to_model_batch(none_collate([self.dataset[j] for j in range(bs)]))

    def flags(self, step):
        warm = step < self.warmup
        return dict(running_avg_scale=warm, use_gt_geo=warm,
                    residuals_weight=0.0 if warm else 1.0)


def _record_grads():
    """An optax transformation that passes its updates on and keeps them as
    its state: ahead of the chain, it hands the step's raw gradients back."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _group(name):
    for g in GROUPS[:-1]:
        if name.startswith(g + "."):
            return g
    return "rest"


def _norms(named_grads, clip):
    """Per-group and global norms of scrubbed gradients, and the clip's scale."""
    sq, bad = dict.fromkeys(GROUPS, 0.0), dict.fromkeys(GROUPS, 0)
    for name, g in named_grads:
        g = np.asarray(g, dtype=np.float64)
        finite = np.isfinite(g)
        bad[_group(name)] += int(g.size - np.count_nonzero(finite))
        g = np.where(finite, g, 0.0)
        sq[_group(name)] += float(np.sum(g * g))
    total = float(np.sqrt(sum(sq.values())))
    return ({k: float(np.sqrt(v)) for k, v in sq.items()}, total,
            1.0 if total < clip else clip / total, bad)


def _flat_tree(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_tree(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _mu_stats(mu, logstd):
    mu, logstd = np.asarray(mu, np.float64), np.asarray(logstd, np.float64)
    return {"mu_mean_abs": float(np.abs(mu).mean()), "mu_max_abs": float(np.abs(mu).max()),
            "logstd_mean": float(logstd.mean())}


class JaxArm:
    """The JAX package as ``train.py`` builds and steps it."""

    def __init__(self, inp: Inputs):
        self.inp = inp
        cfg = inp.cfg
        ds = inp.dataset
        self.model = jax_get_autoencoder(
            inp.uv_jax, vertmean=ds.vertmean, vertstd=ds.vertstd,
            ncams=len(ds.get_allcameras()), nident=len(ds.identities),
            volradius=cfg.model.volradius, nprims=cfg.model.nprims,
            primsize=(cfg.model.primsize,) * 3, colorcal=cfg.model.colorcal,
            bgmodel=cfg.model.bgmodel, raymarch_backend=inp.jax_backend,
            raymarch_options=inp.jax_rm)
        self.variables = jax.tree_util.tree_map(
            np.asarray, jax.device_get(init_model(self.model, jax.random.PRNGKey(0),
                                                  inp.first())))
        self.clip = float(cfg.train.clip)
        self.tx = jax_state.make_optimizer(cfg.train.get("optimizer", "adam"),
                                           cfg.train.init_learning_rate, cfg.train.gamma,
                                           cfg.train.lr_scheduler_iter, cfg.train.clip)
        self.txr = optax.chain(_record_grads(), self.tx)
        self.step_fn = jax_make_train_step(self.model, self.txr, inp.losses, ds.vertmean,
                                           ds.vertstd, output_set=inp.output_set)
        model = self.model

        def encode(m, b):
            code = m.expression_encoder(verts=b["verts"], avgtex=b["avgtex"],
                                        neut_verts=b["neut_verts"], neut_avgtex=b["neut_avgtex"])
            return m.bottleneck(code, deterministic=True)

        self._encode = jax.jit(lambda v, b: model.apply(v, b, method=encode))
        self._cin = self.variables["params"]["bottleneck"]["mu"]["weight"].shape[-2]
        self._noise = jax.jit(lambda v, x, key: model.apply(
            v, x, method=lambda m, x: m.bottleneck(x), rngs={"sample": key})[0])

    def noise(self, step, batch):
        """JAX's draw of the bottleneck noise in step ``step``: the bottleneck
        alone, at its initial weights (bias 0, so z = 0 + exp(0) * noise) on a
        zero code, under the step key (the draw depends on the key, the
        module's path and the shape only)."""
        n = batch["verts"].shape[0]
        x = jnp.zeros((n, 4, 4, self._cin), jnp.float32)
        v = {"params": {"bottleneck": self.variables["params"]["bottleneck"]}}
        key = jax.random.fold_in(jax.random.PRNGKey(0), step)
        return np.asarray(self._noise(v, x, key))

    def run(self, steps, log, save_at=(), savedir=None):
        state = jax_state.create_train_state(
            jax.tree_util.tree_map(jnp.asarray, self.variables), self.txr)
        for i in range(steps):
            t0 = time.time()
            mb = self.inp.batch(i)
            jb = {k: jnp.asarray(v) for k, v in mb.items()}
            noise = self.noise(i, mb)
            _, mu, logstd = self._encode({"params": state.params, "stats": state.stats}, jb)
            if i in save_at:
                dump_state(Path(savedir) / f"J_state_{i}.pkl", state, i, mb, noise)
            key = jax.random.fold_in(jax.random.PRNGKey(0), i)
            state, total, terms = self.step_fn(state, jb, key, cond=None, **self.inp.flags(i))
            grads = jax.tree_util.tree_map(np.asarray, state.opt_state[0])
            gn, tot, scale, bad = _norms(_flat_tree(grads), self.clip)
            log(dict(arm="J", step=i, loss=float(total),
                     **{k: float(v) for k, v in terms.items()}, **_mu_stats(mu, logstd),
                     clip_scale=scale, gnorm_total=tot, gnorm=gn, nonfinite=bad,
                     seconds=time.time() - t0))
        return state


def saved_state(state, step, batch, noise):
    """J's state before ``step`` (the optimizer's without the recorder), the
    step's batch and noise, as numpy trees."""
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(
        {"params": state.params, "stats": state.stats, "opt_state": state.opt_state[1],
         "step": state.step}))
    return {"state": tree, "step": step, "batch": batch, "noise": noise}


def dump_state(path, state, step, batch, noise):
    with open(path, "wb") as f:
        pickle.dump(saved_state(state, step, batch, noise), f)


class PortArm:
    """The port as ``train.loop`` builds and steps it, on the CPU."""

    def __init__(self, inp: Inputs, init_tree=None, name="P"):
        self.inp, self.name = inp, name
        cfg = inp.cfg
        self.model = loop.build_model(cfg, inp.dataset, inp.uv_port, "cpu", seed=0)
        if init_tree is not None:
            load_flax(self.model, init_tree)
        self.clip = float(cfg.train.clip)
        self.optimizer = make_optimizer(self.model, cfg.train.get("optimizer", "adam"),
                                        cfg.train.init_learning_rate, cfg.train.gamma,
                                        cfg.train.lr_scheduler_iter, cfg.train.clip)
        self.step_fn = make_train_step(self.model, self.optimizer, inp.losses,
                                       inp.dataset.vertmean, inp.dataset.vertstd,
                                       output_set=inp.output_set)
        self.state = TrainState(self.model, self.optimizer, 0)
        self._seen = {}
        self.model.bottleneck.register_forward_hook(
            lambda m, i, out: self._seen.__setitem__("bottleneck", out))

    def step(self, i, mb, noise):
        """One step; returns (total, terms, grads before the clip by name)."""
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in mb.items()}
        raw = {}

        def mark(what):
            if what == "backward":
                raw.update({n: p.grad.detach().clone() for n, p in
                            self.model.named_parameters() if p.grad is not None})

        self.state, total, terms = self.step_fn(
            self.state, tb, noise=torch.tensor(np.asarray(noise)), mark=mark,
            **self.inp.flags(i))
        return total, terms, raw

    def run(self, steps, log, noise_of):
        for i in range(steps):
            t0 = time.time()
            mb = self.inp.batch(i)
            total, terms, raw = self.step(i, mb, noise_of(i, mb))
            _, mu, logstd = (t.detach() for t in self._seen["bottleneck"])
            gn, tot, scale, bad = _norms(((n, g.numpy()) for n, g in raw.items()), self.clip)
            log(dict(arm=self.name, step=i, loss=float(total),
                     **{k: float(v) for k, v in terms.items()},
                     **_mu_stats(mu.numpy(), logstd.numpy()), clip_scale=scale,
                     gnorm_total=tot, gnorm=gn, nonfinite=bad, seconds=time.time() - t0))


def bump_one_ulp(tree, path=("bottleneck", "mu", "weight"), index=0):
    """A copy of a variables tree with one weight moved up by one ulp; with
    ``path`` None, every parameter."""
    out = jax.tree_util.tree_map(np.array, tree)
    if path is None:
        out["params"] = jax.tree_util.tree_map(
            lambda x: np.nextafter(x, np.float32(np.inf)).astype(x.dtype), out["params"])
        return out
    leaf = out["params"]
    for k in path:
        leaf = leaf[k]
    flat = leaf.reshape(-1)
    flat[index] = np.nextafter(flat[index], np.float32(np.inf))
    return out


def run_arms(inp: Inputs, arms, steps, log, save_at=(), savedir=None) -> JaxArm:
    """Run ``arms`` in turn for ``steps`` steps each; J's draw of the noise
    feeds every arm. Returns the JAX arm (its model and initial weights)."""
    jarm = JaxArm(inp)
    for arm in arms:
        if arm == "J":
            jarm.run(steps, log, save_at, savedir)
            continue
        tree = None
        if arm == "P-J":
            tree = jarm.variables
        elif arm == "P-J-ulp":
            tree = bump_one_ulp(jarm.variables)
        elif arm == "P-J-ulps":
            tree = bump_one_ulp(jarm.variables, path=None)
        PortArm(inp, tree, arm).run(steps, log, jarm.noise)
    return jarm


# ---------------------------------------------------------------------------
# one step from a trained state, in both packages
# ---------------------------------------------------------------------------


def jax_train_state(jarm: JaxArm, tree):
    """A JAX ``TrainState`` (with the recorder ahead of the optimizer) from a
    numpy tree of params, stats, opt_state and step."""
    return jax_state.TrainState(
        params=jax.tree_util.tree_map(jnp.asarray, tree["params"]),
        stats=jax.tree_util.tree_map(jnp.asarray, tree["stats"]),
        opt_state=(jax.tree_util.tree_map(jnp.zeros_like, tree["params"]),
                   jax.tree_util.tree_map(jnp.asarray, tree["opt_state"])),
        step=jnp.asarray(tree["step"]))


def compare_trained_step(inp: Inputs, jarm: JaxArm, saved):
    """One step ``saved["step"]`` from the saved state (``dump_state``'s
    dict) in both packages, with its batch and noise. Returns both sides'
    loss terms, gradients, parameters before and after, and statistics, in
    the port's names and layouts."""
    from ava256_tpu_torch.convert import load_train_state

    i, mb, noise, tree = saved["step"], saved["batch"], saved["noise"], saved["state"]
    jb = {k: jnp.asarray(v) for k, v in mb.items()}
    key = jax.random.fold_in(jax.random.PRNGKey(0), i)
    jstate = jax_train_state(jarm, tree)
    _, jmu, jlogstd = jarm._encode({"params": jstate.params, "stats": jstate.stats}, jb)
    jnew, _, jterms = jarm.step_fn(jstate, jb, key, cond=None, **inp.flags(i))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    port = PortArm(inp, None, "P-J")
    port.state = load_train_state(port.state, tree)
    before = {n: p.detach().clone() for n, p in port.model.named_parameters()}
    _, terms, raw = port.step(i, mb, noise)
    _, pmu, plogstd = (t.detach() for t in port._seen["bottleneck"])
    stats = as_np(jnew.stats)
    ref_grads = flax_to_state_dict({"params": as_np(jnew.opt_state[0]), "stats": stats},
                                   port.model)
    ref_params = flax_to_state_dict({"params": as_np(jnew.params), "stats": stats}, port.model)
    names = [n for n, _ in port.model.named_parameters()]
    return dict(
        step=i, clip=port.clip, names=names, before=before,
        jmu=np.asarray(jmu), jlogstd=np.asarray(jlogstd), pmu=pmu.numpy(),
        plogstd=plogstd.numpy(),
        jterms={k: float(v) for k, v in jterms.items()},
        pterms={k: float(v) for k, v in terms.items()},
        jgrads={n: ref_grads[n] for n in names},
        pgrads={n: raw.get(n, torch.zeros_like(before[n])) for n in names},
        jparams={n: ref_params[n] for n in names},
        pparams={n: p.detach().clone() for n, p in port.model.named_parameters()},
        jstats=ref_grads["decoder_assembler.adaptwarps"],
        pstats=port.model.decoder_assembler.adaptwarps.detach().clone())


def _cos_rel(ref, got):
    a = np.concatenate([r.numpy().ravel() for r in ref]).astype(np.float64)
    b = np.concatenate([g.numpy().ravel() for g in got]).astype(np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    return float(a @ b / (na * nb + 1e-300)), float(nb / (na + 1e-300)), float(na)


def trained_step_report(r):
    """What ``compare_trained_step`` found, as numbers: each gradient group's
    cosine and norm ratio, the clip's scale in both, the update of the
    ``g``s and of each group by cosine and norm ratio, and ``adaptwarps``."""
    rep = {"step": r["step"], "jterms": r["jterms"], "pterms": r["pterms"], "grads": {},
           "updates": {}}
    for g in GROUPS:
        ns = [n for n in r["names"] if _group(n) == g]
        rep["grads"][g] = _cos_rel([r["jgrads"][n] for n in ns], [r["pgrads"][n] for n in ns])
        rep["updates"][g] = _cos_rel([r["jparams"][n] - r["before"][n] for n in ns],
                                     [r["pparams"][n] - r["before"][n] for n in ns])
    gs = [n for n in r["names"] if n.endswith(".g")]
    rep["updates"]["g"] = _cos_rel([r["jparams"][n] - r["before"][n] for n in gs],
                                   [r["pparams"][n] - r["before"][n] for n in gs])
    _, jn, js, _ = _norms(((n, r["jgrads"][n].numpy()) for n in r["names"]), r["clip"])
    _, pn, ps, _ = _norms(((n, r["pgrads"][n].numpy()) for n in r["names"]), r["clip"])
    rep["clip_scale"] = {"jax": js, "port": ps, "jax_norm": jn, "port_norm": pn}
    rep["adaptwarps_max_rel"] = float((r["pstats"] - r["jstats"]).abs().max()
                                      / r["jstats"].abs().max())
    return rep


# ---------------------------------------------------------------------------
# the tier-1 test
# ---------------------------------------------------------------------------

STEPS = 6
EXACT_STEPS = 3
EXACT_REL = 1e-4
# the KL term is a mean of terms about 0.5 in size that cancel to about 1e-5:
# one float32 ulp of 0.5
KL_ABS = 6e-8
ULP_FACTOR = 10.0
WINDOW = 3


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    inp = Inputs(tmp_path_factory.mktemp("trajectory"), TINY)
    lines = []
    jarm = run_arms(inp, ("J", "P-J", "P-J-ulps"), STEPS, lines.append)
    by = {}
    for line in lines:
        by.setdefault(line["arm"], {})[line["step"]] = line
    return inp, jarm, by


def _slack(term, ref):
    return EXACT_REL * abs(ref) + (KL_ABS if term == "kldiv" else 0.0)


def test_noise_is_the_jax_draw(tiny_runs):
    """The bottleneck alone under the step key draws what the whole model's
    forward draws: (z - mu) / exp(logstd) of a forward of step 3's batch."""
    from ava256_tpu.train.step import BATCH_MODEL_KEYS

    inp, jarm, _ = tiny_runs
    mb = {k: jnp.asarray(v) for k, v in inp.batch(3).items()}
    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    out = jax.jit(lambda v, b, k: jarm.model.apply(
        v, target_neut_avgtex=b["neut_avgtex"], target_neut_verts=b["neut_verts"],
        idindex=b["idindex"], camindex=b["camindex"], rngs={"sample": k}, render=False,
        **{k_: b[k_] for k_ in BATCH_MODEL_KEYS}))(jarm.variables, mb, key)
    ref = (np.asarray(out["encoding"]) - np.asarray(out["expr_mu"])) / np.exp(
        np.asarray(out["expr_logstd"]))
    np.testing.assert_allclose(jarm.noise(3, inp.batch(3)), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("term", TERMS + ("loss",))
def test_port_tracks_jax_step_by_step(tiny_runs, term):
    _, _, by = tiny_runs
    j, p, u = by["J"], by["P-J"], by["P-J-ulps"]
    assert sorted(j) == sorted(p) == sorted(u) == list(range(STEPS))
    d_ulp = 0.0  # how far the 1-ulp twin has parted from P-J so far
    for i in range(STEPS):
        ref = j[i][term]
        assert np.isfinite(p[i][term]), i
        d_port = abs(p[i][term] - ref)
        if i < EXACT_STEPS:
            assert d_port <= _slack(term, ref), (i, p[i][term], ref)
        # the port parts from JAX no faster than from itself moved by one ulp
        d_ulp = max(d_ulp, abs(u[i][term] - p[i][term]))
        assert d_port <= ULP_FACTOR * d_ulp + _slack(term, ref), (i, p[i][term], ref, d_ulp)
    window = range(STEPS - WINDOW, STEPS)
    mj, mp = (np.median([arm[i][term] for i in window]) for arm in (j, p))
    assert abs(mp - mj) <= ULP_FACTOR * d_ulp + _slack(term, mj), (mp, mj, d_ulp)


def test_port_logs_bottleneck_clip_and_gradients_like_jax(tiny_runs):
    """The logged diagnostics agree where the losses do: |mu|, logstd, the
    clip's scale and the gradient norm of every group in the first steps,
    and no gradient entry is non-finite in either package."""
    _, _, by = tiny_runs
    for i in range(EXACT_STEPS):
        j, p = by["J"][i], by["P-J"][i]
        for k in ("mu_mean_abs", "mu_max_abs", "clip_scale", "gnorm_total"):
            assert abs(p[k] - j[k]) <= 1e-3 * abs(j[k]), (i, k, p[k], j[k])
        assert abs(p["logstd_mean"] - j["logstd_mean"]) <= 1e-3 * abs(j["mu_mean_abs"]), i
        for g in GROUPS:
            assert j["gnorm"][g] > 0.0, (i, g)
            assert abs(p["gnorm"][g] - j["gnorm"][g]) <= 1e-3 * j["gnorm"][g], (i, g)
    for arm in by.values():
        for line in arm.values():
            assert not any(line["nonfinite"].values()), line


# ---------------------------------------------------------------------------
# the long mode
# ---------------------------------------------------------------------------


def table(paths, steps) -> str:
    """A markdown table of the arms' logs (``<arm>.jsonl`` files): KL,
    largest |mu|, the clip's scale and irgbl1 at ``steps``."""
    arms = {}
    for path in paths:
        for line in open(path):
            x = json.loads(line)
            arms.setdefault(x["arm"], {})[x["step"]] = x
    head = "| step | " + " | ".join(f"{a} KL | {a} max abs mu | {a} clip | {a} irgbl1"
                                    for a in arms) + " |"
    rows = [head, "|---" * (1 + 4 * len(arms)) + "|"]
    for i in steps:
        cells = []
        for d in arms.values():
            x = d.get(i)
            cells += ([f"{x['kldiv']:.4g}", f"{x['mu_max_abs']:.3f}", f"{x['clip_scale']:.4f}",
                       f"{x['irgbl1']:.3f}"] if x else [""] * 4)
        rows.append(f"| {i} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--arms", default="J,P-J,P-own")
    ap.add_argument("--save-at", default="18,22,26,30")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--jax-backend", default="pallas",
                    help="JAX's marcher (pallas: its kernels, interpreted on the CPU)")
    ap.add_argument("--tiny", action="store_true", help="the tier-1 size, not the flagship's")
    ap.add_argument("--trained-step", default=None, metavar="J_STATE_PKL")
    ap.add_argument("--table", default=None, metavar="STEPS",
                    help="print the table of OUT/*.jsonl at these steps (a comma list) and exit")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    if args.table:
        paths = sorted(Path(args.out).glob("*.jsonl"))
        print(table(paths, [int(s) for s in args.table.split(",")]))
        return 0
    if args.threads:
        torch.set_num_threads(args.threads)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    inp = Inputs(out / "work", (TINY if args.tiny else LONG) + args.overrides, args.jax_backend)
    if args.trained_step:
        with open(args.trained_step, "rb") as f:
            saved = pickle.load(f)
        report = trained_step_report(compare_trained_step(inp, JaxArm(inp), saved))
        print(json.dumps(report, indent=1))
        return 0
    save_at = {int(s) for s in args.save_at.split(",") if s}
    arms = args.arms.split(",")
    files = {a: open(out / f"{a}.jsonl", "a") for a in arms}

    def log(line):
        files[line["arm"]].write(json.dumps(line) + "\n")
        files[line["arm"]].flush()
        print(json.dumps({k: v for k, v in line.items() if k != "gnorm"}), flush=True)

    run_arms(inp, arms, args.steps, log, save_at, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
