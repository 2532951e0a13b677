# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Data parallelism of the port (``ava256_tpu_torch.parallel``) on the CPU:
two processes on gloo, started as ``tests/test_multihost.py`` starts its
workers, with the launcher's environment set by hand. The counterparts of
``tests/test_multihost.py`` and ``tests/test_parallel.py``.

The model is the reduced one of ``tests/test_torch_port_model.py`` (256
primitives of 16^3, so the adaptive-scale branch and its max over the
batch run), with the perturbed, converted JAX weights of
``tests/test_torch_port_train.py``. Two ranks with one item each take a
warm-up step (the JAX draw of the bottleneck noise for the batch of 2, each
rank its row) and a normal step (noise from the step's generator):

- both ranks log the same losses, and they equal one process's at batch 2
  to 1e-5 relative (plus 1e-9 for the KL term, a mean of differences of
  terms about 0.5 in size); after the two steps the parameters and ``adaptwarps``
  equal one process's to 1e-5 of each tensor's largest value, and each
  parameter's update has cosine > 0.9999 with that process's;
- the warm-up step against the JAX ``make_train_step`` at batch 2 with the
  same noise, to the tolerances of ``test_train_step_matches_jax``: loss
  terms to 1e-4 relative, ``adaptwarps`` to 1e-4, every averaged gradient to
  cosine > 0.9999 and max |d| <= 1e-3 max |ref|. The background MLP's are
  first held to one process's at 1e-5, then, pinned as there
  (``_bg_grads_pinned``), to JAX;
- the rows of a render split over the two ranks, 20 rows with tile 8 (the
  second slab ends inside a tile), equal the whole render at rtol = atol =
  1e-4 (``tests/test_parallel.py``'s tolerance);
- with no group up: rank 0 of 1, the collectives are no-ops;
- ``mesh.multihost: true`` without a launcher's environment raises;
- ``cli.train`` under two ranks over 5 items (3 and 2 per rank before the
  shards are cut to the same length) with one item that fails to load:
  both ranks take the same steps, skip the same ones and finish.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ava256_tpu_torch import parallel  # noqa: E402
from ava256_tpu_torch.data.synthetic import SyntheticDataset, synthetic_uvdata  # noqa: E402
from ava256_tpu_torch.factory import get_autoencoder  # noqa: E402
from ava256_tpu_torch.render import BATCH_MODEL_KEYS  # noqa: E402
from ava256_tpu_torch.train.state import TrainState, make_optimizer  # noqa: E402
from ava256_tpu_torch.train.step import make_train_step, step_generator  # noqa: E402

from tests import _torch_port_threads  # noqa: E402,F401

OPTS = {"tile": 8, "max_hit": 16, "nbuf": 64, "dt": 16.0}  # tests/test_torch_port_model.py
LOSS_WEIGHTS = dict(irgbl1=1.0, vertl1=0.1, kldiv=1.0e-3, primvolsum=0.01)
WARMUP = dict(running_avg_scale=True, use_gt_geo=True, residuals_weight=0.0)
NORMAL = dict(running_avg_scale=False, use_gt_geo=False, residuals_weight=1.0)
RENDER_ROWS = 20  # two slabs of 16 rows (two tiles of 8), the second cut at row 20
# torch's threads in the one process and in each rank: a conv's weight gradient
# sums in an order that follows them, and the comparisons below hold at these
# counts, whatever share of the cores the test worker has
SINGLE_THREADS, RANK_THREADS = 4, 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(nproc: int, mode: str, workdir: Path, timeout: float) -> None:
    """Run ``nproc`` workers of this file in ``mode``, as ranks of one gloo
    group, each with the environment torchrun would give it."""
    port = str(_free_port())
    procs = []
    for r in range(nproc):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(nproc), LOCAL_RANK=str(r),
                   MASTER_ADDR="localhost", MASTER_PORT=port, OMP_NUM_THREADS=str(RANK_THREADS),
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), mode,
                                       str(workdir)], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True, env=env))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"


def _dataset():
    return SyntheticDataset(nident=2, ncams=2, height=32, width=32, texsize=64)


def _model(ds, state_dict=None):
    port = get_autoencoder(synthetic_uvdata(64), ds.vertmean, ds.vertstd, ncams=2, nident=2,
                           nprims=256, primsize=(16,) * 3, raymarch_options=OPTS, device="cpu")
    if state_dict is not None:
        port.load_state_dict(state_dict)
    return port


def _decode(model, batch):
    """The deterministic render of ``batch``, its ``bg`` used when given."""
    with torch.no_grad():
        return model(target_neut_avgtex=batch["neut_avgtex"],
                     target_neut_verts=batch["neut_verts"], idindex=batch["idindex"],
                     camindex=batch["camindex"], deterministic=True, bg=batch.get("bg"),
                     **{k: batch[k] for k in BATCH_MODEL_KEYS})["irgbrec"]


def _render_batch(model, batch):
    """The batch cut to RENDER_ROWS rows, with the whole image's background."""
    out = {k: v[:, :RENDER_ROWS] if k == "pixelcoords" else v for k, v in batch.items()}
    pix = out["pixelcoords"]
    samplecoords = torch.cat([pix[..., :1] * 2.0 / (pix.shape[-2] - 1) - 1.0,
                              pix[..., 1:] * 2.0 / (pix.shape[-3] - 1) - 1.0], dim=-1)
    with torch.no_grad():
        out["bg"] = model.bgmodel(out["camindex"], out["idindex"], samplecoords)
    return out


def _two_steps(model, batch, noise0, vertmean, vertstd, clip=1.0):
    """The warm-up step with ``noise0``, then a normal step with noise from
    the step's generator. Returns ([(total, terms)] per step, the warm-up
    step's gradients after the all-reduce)."""
    opt = make_optimizer(model, "adam", 2e-4, 1.4, 10_000, clip)
    step = make_train_step(model, opt, LOSS_WEIGHTS, vertmean, vertstd)
    state, losses, grads = TrainState(model, opt, 0), [], {}

    def keep(name):
        if name == "backward" and not grads:
            grads.update({n: None if p.grad is None else p.grad.clone()
                          for n, p in model.named_parameters()})

    for flags, noise in ((WARMUP, noise0), (NORMAL, None)):
        gen = None if noise is not None else step_generator("cpu", state.step)
        state, total, terms = step(state, batch, generator=gen, noise=noise, mark=keep, **flags)
        losses.append((float(total), {k: float(v) for k, v in terms.items()}))
    return losses, grads


# cli.train over 5 items of one identity (5 cameras, 1 frame), one item per
# rank and step, 2 epochs; item FAILING_ITEM fails to load
FAILING_ITEM = 2
LOOP_EPOCHS = 2


def loop_overrides(workdir: Path) -> list:
    return [f"assets={workdir / 'assets'}", f"progress.output_path={workdir / 'run'}",
            "train.maxiter=100", f"train.num_epochs={LOOP_EPOCHS}", "train.nids=1",
            "train.batchsize=1", "train.num_workers=1", "data.synthetic_cams=5",
            "data.synthetic_frames=1", "model.nprims=256", "model.primsize=16",
            "data.synthetic_texsize=64", "data.synthetic_height=32", "data.synthetic_width=32",
            "model.raymarch.tile=8", "model.raymarch.max_hit=16", "model.raymarch.nbuf=64",
            "model.raymarch.dt=16.0"]


def _worker(mode: str, workdir: Path) -> None:
    torch.set_num_threads(RANK_THREADS)
    if mode == "loop":  # cli.train joins the group and leaves it
        from ava256_tpu_torch.cli import train as cli_train
        from ava256_tpu_torch.data import synthetic

        get = synthetic.SyntheticDataset.__getitem__
        synthetic.SyntheticDataset.__getitem__ = (
            lambda self, i: None if int(i) == FAILING_ITEM else get(self, i))
        state = cli_train.main(["--config", "configs/config-synthetic.yaml", "--device", "cpu"]
                               + loop_overrides(workdir) + ["mesh.multihost=true"])
        (workdir / f"rank{os.environ['RANK']}.json").write_text(json.dumps(dict(
            steps=state.step, counts=parallel.COUNTS, group_left=not parallel.is_initialized())))
        return
    device = parallel.init_from_env("cpu")
    assert (parallel.backend(), parallel.world_size(), device) == ("gloo", 2, torch.device("cpu"))
    try:
        inputs = torch.load(workdir / "inputs.pt", weights_only=False)
        ds = _dataset()
        model = _model(ds, inputs["state_dict"])
        rows = parallel.batch_rows(1)
        local = {k: v[rows] for k, v in inputs["batch"].items()}
        losses, grads = _two_steps(model, local, inputs["noise"][rows], ds.vertmean, ds.vertstd)
        # every rank decodes the whole batch and marches its rows
        image = parallel.render_rays_sharded(
            lambda b: _decode(model, b), _render_batch(model, inputs["batch"]), OPTS["tile"])
        torch.save(dict(losses=losses, grads=grads, image=image, counts=dict(parallel.COUNTS),
                        state_dict=model.state_dict()), workdir / f"rank{parallel.rank()}.pt")
    finally:
        parallel.destroy()


# ---------------------------------------------------------------------------
# two ranks against one process and against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import copy

    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _build
    from ava256_tpu.train import state as jax_state
    from ava256_tpu.train.init import init_model
    from ava256_tpu.train.step import make_train_step as jax_make_train_step
    from ava256_tpu_torch.convert import flax_to_state_dict
    from ava256_tpu_torch.data.synthetic import none_collate
    from tests.test_torch_port_model import SIZES, _perturb
    from tests.test_torch_port_train import _capture_grads

    model, mb, dsj = _build(raymarch_backend="pallas",
                            raymarch_options=dict(OPTS, interpret=True), **SIZES)
    variables = init_model(model, jax.random.PRNGKey(0), mb)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    tree = {"params": _perturb(tree["params"], np.random.RandomState(7)), "stats": tree["stats"]}
    # as tests/test_torch_port_train.py: rays of every kind, not all saturated
    geodec = tree["params"]["decoder_assembler"]["geodec"]
    geodec["slab_bias"] = geodec["slab_bias"] - 12.0
    jvars = jax.tree_util.tree_map(jnp.asarray, tree)

    # the JAX step's noise for the batch of 2, from a forward without the march
    rng = jax.random.PRNGKey(3)
    enc = jax.jit(lambda v, b, k: model.apply(
        v, target_neut_avgtex=b["neut_avgtex"], target_neut_verts=b["neut_verts"],
        idindex=b["idindex"], camindex=b["camindex"], rngs={"sample": k}, render=False,
        **{k_: b[k_] for k_ in BATCH_MODEL_KEYS}))(jvars, mb, rng)
    noise = ((np.asarray(enc["encoding"]) - np.asarray(enc["expr_mu"]))
             / np.exp(np.asarray(enc["expr_logstd"])))
    tx = _capture_grads()
    jstep = jax_make_train_step(model, tx, LOSS_WEIGHTS, dsj.vertmean, dsj.vertstd)
    jnew, jtotal, jterms = jstep(jax_state.create_train_state(jvars, tx), mb, rng, **WARMUP)

    ds = _dataset()
    batch_np = none_collate([ds[i] for i in range(2)])
    batch = {k: torch.from_numpy(np.asarray(batch_np[k])) for k in mb}
    single = _model(ds)
    state_dict = flax_to_state_dict(tree, single)
    single.load_state_dict(state_dict)
    work = tmp_path_factory.mktemp("ddp_step")
    torch.save(dict(state_dict=state_dict, batch=batch, noise=torch.from_numpy(noise)),
               work / "inputs.pt")
    _launch(2, "step", work, timeout=600)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]

    # one process at batch 2, the background's inputs and cotangent kept
    bg_io = {"before": copy.deepcopy(single.bgmodel)}

    def keep_bg(module, inputs, output):
        if "inputs" not in bg_io:
            bg_io["inputs"] = tuple(x.detach() for x in inputs)
            output.register_hook(lambda g: bg_io.__setitem__("cotangent", g))

    hook = single.bgmodel.register_forward_hook(keep_bg)
    threads = torch.get_num_threads()
    torch.set_num_threads(SINGLE_THREADS)
    try:
        losses, grads = _two_steps(single, batch, torch.from_numpy(noise), ds.vertmean,
                                   ds.vertstd)
    finally:
        torch.set_num_threads(threads)
    hook.remove()
    # the whole render, with the weights the ranks rendered with
    after = _model(ds, ranks[0]["state_dict"])
    whole = _decode(after, _render_batch(after, batch))
    jgrads = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jnew.opt_state),
                                 "stats": tree["stats"]}, single)
    jstats = jax.tree_util.tree_map(np.asarray, jnew.stats)
    return dict(ranks=ranks, losses=losses, grads=grads, model=single, whole=whole,
                init=state_dict,
                bg_io=bg_io, jax=dict(total=float(jtotal), grads=jgrads,
                                      terms={k: float(v) for k, v in jterms.items()},
                                      adaptwarps=jstats["decoder_assembler"]["adaptwarps"]))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum() + 1e-300))


def test_two_ranks_take_the_steps_of_one_process(runs):
    (l0, l1), ref = (r["losses"] for r in runs["ranks"]), runs["losses"]
    assert l0 == l1, (l0, l1)  # the returned losses are the global batch's means
    for (total, terms), (rtotal, rterms) in zip(l0, ref):
        assert abs(total - rtotal) <= 1e-5 * abs(rtotal), (total, rtotal)
        assert set(terms) == set(rterms)
        for k in terms:
            # kldiv (about 7e-6) is a mean of differences of terms about 0.5 in
            # size: its rounding is 1e-9 of those, not of its own value
            assert abs(terms[k] - rterms[k]) <= 1e-5 * abs(rterms[k]) + 1e-9, \
                (k, terms[k], rterms[k])
    single, init = runs["model"].state_dict(), runs["init"]
    assert float(single["decoder_assembler.adaptwarps"].max()) > 0
    bad = []
    for r, rank in enumerate(runs["ranks"]):
        for name, p in rank["state_dict"].items():
            if _rel(p, single[name]) > 1e-5:
                bad.append(f"rank {r} {name}: {_rel(p, single[name]):.3g}")
            if name in dict(runs["model"].named_parameters()):
                step, ref = p - init[name], single[name] - init[name]
                if not ref.any():  # no gradient reached it: no update on any rank either
                    if step.any():
                        bad.append(f"rank {r} {name}: moved, one process's did not")
                elif not _cos(step, ref) > 0.9999:
                    bad.append(f"rank {r} {name}: update cosine {_cos(step, ref)}")
    assert not bad, bad[:10]
    counts = runs["ranks"][0]["counts"]
    assert counts["all_reduce_gradients"] == counts["all_reduce_mean"] == 2, counts
    assert counts["all_reduce_max"] == 1, counts  # the warm-up step's adaptive scale


def test_two_ranks_take_the_jax_step(runs, monkeypatch):
    from tests.test_torch_port_train import _bg_grads_pinned

    ref, (total, terms) = runs["jax"], runs["ranks"][0]["losses"][0]
    assert set(terms) == set(ref["terms"])
    for k, v in ref["terms"].items():
        assert abs(terms[k] - v) <= 1e-4 * abs(v) + 1e-7, (k, terms[k], v)
    assert abs(total - ref["total"]) <= 1e-4 * abs(ref["total"])
    # adaptwarps after the warm-up step, before the normal one leaves it alone
    aw = runs["ranks"][0]["state_dict"]["decoder_assembler.adaptwarps"].numpy()
    assert np.abs(aw - ref["adaptwarps"]).max() <= 1e-4 * np.abs(ref["adaptwarps"]).max() + 1e-4
    grads, single = runs["ranks"][0]["grads"], runs["grads"]
    io = runs["bg_io"]
    bg_plain, bg_pinned, npinned = _bg_grads_pinned(io["before"], io["inputs"],
                                                    io["cotangent"], ref["grads"], monkeypatch)
    assert npinned <= 16, npinned
    checked, bad = 0, []
    for name, g in grads.items():
        assert (g is None) == (single[name] is None), name
        g = torch.zeros_like(ref["grads"][name]) if g is None else g
        if name in bg_pinned:
            # the ranks' average repeats one process's background gradients,
            # which are then pinned to the reference's side as in the train test
            assert _rel(g, bg_plain[name]) <= 1e-5, name
            g = bg_pinned[name]
        a, b = ref["grads"][name].numpy(), g.numpy()
        assert np.isfinite(b).all(), name
        if np.abs(a).max() == 0.0:
            assert np.abs(b).max() == 0.0, name
            continue
        if not (_cos(a, b) > 0.9999 and _rel(b, a) <= 1e-3):
            bad.append(f"{name}: cos {_cos(a, b)}, max|d|/max|ref| {_rel(b, a)}")
        checked += 1
    assert not bad, bad
    assert checked > 50


def test_sharded_render_matches_whole_render(runs):
    whole = runs["whole"]
    assert whole.shape[1] == RENDER_ROWS and float(whole.std()) > 0
    for rank in runs["ranks"]:
        assert rank["image"].shape == whole.shape
        np.testing.assert_allclose(rank["image"].numpy(), whole.numpy(), rtol=1e-4, atol=1e-4)
    assert runs["ranks"][0]["counts"]["all_gather"] == 1


def test_no_group_is_one_process():
    assert not parallel.is_initialized()
    assert (parallel.rank(), parallel.world_size(), parallel.backend()) == (0, 1, None)
    assert parallel.batch_rows(3) == slice(0, 3)
    before = dict(parallel.COUNTS)
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 2.0)
    parallel.all_reduce_gradients([p])
    terms = {"a": torch.tensor(1.5)}
    assert parallel.all_reduce_mean(terms) is terms
    t = torch.arange(4.0)
    assert parallel.all_reduce_max_(t) is t and torch.equal(t, torch.arange(4.0))
    assert parallel.all_ranks(True, "cpu") and not parallel.all_ranks(False, "cpu")
    assert parallel.all_gather(t)[0] is t
    parallel.barrier()
    batch = {"pixelcoords": torch.zeros(1, 5, 4, 2)}
    assert parallel.render_rays_sharded(lambda b: b["pixelcoords"], batch, 8) is \
        batch["pixelcoords"]
    assert torch.equal(p.grad, torch.full((3,), 2.0))
    assert parallel.COUNTS == before


def test_multihost_without_a_launcher_raises(monkeypatch, tmp_path):
    from ava256_tpu_torch.config import load_config
    from ava256_tpu_torch.train import loop

    for var in parallel.mesh.LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    cfg = load_config(os.path.join(ROOT, "configs/config-synthetic.yaml"),
                      ["mesh.multihost=true", f"progress.output_path={tmp_path}"])
    with pytest.raises(RuntimeError, match="torchrun"):
        loop.run(cfg, device="cpu")
    assert not parallel.is_initialized()


def test_ranks_of_unequal_shards_step_together(tmp_path, monkeypatch):
    from ava256_tpu_torch.config import load_config
    from ava256_tpu_torch.data import ShardedLoader
    from ava256_tpu_torch.data.synthetic import write_topology_obj

    write_topology_obj(tmp_path / "assets" / "face_topology.obj")
    monkeypatch.setenv("AVA256_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.chdir(ROOT)
    _launch(2, "loop", tmp_path, timeout=600)
    out = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    # the steps where neither rank's item is the failing one
    cfg = load_config(os.path.join(ROOT, "configs/config-synthetic.yaml"),
                      loop_overrides(tmp_path))
    items = cfg.data.synthetic_cams
    shards = []
    for r in range(2):
        loader = ShardedLoader(list(range(items)), batch_size=1, host_id=r, num_hosts=2)
        shards.append([])
        for _ in range(LOOP_EPOCHS):
            shards[r] += list(loader._epoch_indices())
            loader.epoch += 1
    assert [len(s) for s in shards] == [LOOP_EPOCHS * (items // 2)] * 2
    steps = sum(FAILING_ITEM not in pair for pair in zip(*shards))
    assert 0 < steps < len(shards[0]), shards  # some step was skipped
    assert [o["steps"] for o in out] == [steps, steps], out
    assert all(o["group_left"] for o in out)
    assert out[0]["counts"]["all_ranks"] == len(shards[0]) == out[1]["counts"]["all_ranks"]
    assert (tmp_path / "run" / "checkpoints" / f"step_{steps:08d}.pt").is_file()


if __name__ == "__main__":
    _worker(sys.argv[1], Path(sys.argv[2]))
