# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The port's entry points (``ava256_tpu_torch.cli``) against the JAX
package's root scripts on the CPU, on ``configs/config-synthetic.yaml``
reduced by overrides (256 primitives of 16^3, 32x32 rays, 64^2 textures,
batch 2, the last of 3 cameras held out, 2 steps, 64 step rows of 16 / 256,
``assets=`` a directory with the topology ``.obj`` of
``data.synthetic.write_topology_obj``). The JAX side marches with its
Pallas kernels in interpret mode, as ``tests/test_torch_port_model.py`` runs
them, on a one-device mesh.

- ``train.py`` and ``cli.train``: the same (idindex, camindex) batch
  sequence, no held-out camera in it, the device tables and lean batches
  handed to every step of the port, the same checkpoints and
  ``timesinfo_r0.npy`` (the JAX side's progress renders are left out, the
  port's checked for their sizes);
- ``eval.py --holdout-cameras 1`` and ``cli.eval`` over the same weights
  (the JAX checkpoint restored with ``restore_checkpoint`` and converted by
  ``convert.load_train_state``): the same keys, psnr_db, ssim and lpips_rf
  within 1e-4 relative (the unrounded means);
- ``render.py`` / ``cli.render`` and ``generate_id_cond.py`` /
  ``cli.generate_id_cond``: the same file names, the renders' pixels within
  a few levels, the id-cond arrays (same keys, same NHWC shapes) within
  1e-4 of their largest value.
"""

import contextlib
import io
import json
import os
import pickle
import sys

import numpy as np
import pytest

import jax

from ava256_tpu_torch.cli import eval as port_eval
from ava256_tpu_torch.cli import generate_id_cond as port_idc
from ava256_tpu_torch.cli import render as port_render
from ava256_tpu_torch.cli import train as port_train
from ava256_tpu_torch.config import load_config
from ava256_tpu_torch.convert import load_train_state
from ava256_tpu_torch.data.synthetic import write_topology_obj
from ava256_tpu_torch.train import loop
from ava256_tpu_torch.train.state import TrainState, make_optimizer, save_checkpoint

from tests import _torch_port_threads  # noqa: F401
import ava256_tpu.platform
import ava256_tpu.train.init
from ava256_tpu.parallel.mesh import make_mesh

CONFIG = "configs/config-synthetic.yaml"
SHRINK = ["train.maxiter=2", "model.nprims=256", "model.primsize=16",
          "data.synthetic_texsize=64", "data.synthetic_height=32", "data.synthetic_width=32",
          "train.batchsize=2", "data.synthetic_cams=3", "data.holdout_cameras=1",
          "model.raymarch.tile=8", "model.raymarch.max_hit=16", "model.raymarch.nbuf=64",
          "model.raymarch.dt=16.0"]


def _json_line(text):
    return json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])


def _run_script(module, argv):
    """Run a root script's main() with ``argv``; returns its stdout."""
    out = io.StringIO()
    old = sys.argv
    sys.argv = [module.__name__ + ".py"] + argv
    try:
        with contextlib.redirect_stdout(out):
            module.main()
    finally:
        sys.argv = old
    return out.getvalue()


def _recording(make_train_step, seen):
    def make(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def recorded(state, batch, *a, **kw):
            seen.append((np.asarray(batch["idindex"]).tolist(),
                         np.asarray(batch["camindex"]).tolist(), kw.get("cond") is not None,
                         sorted(batch)))
            return step(state, batch, *a, **kw)

        return recorded

    return make


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import eval as jax_eval
    import generate_id_cond as jax_idc
    import render as jax_render
    import train as jax_train
    from ava256_tpu.train.state import restore_checkpoint

    tmp = tmp_path_factory.mktemp("cli")
    write_topology_obj(tmp / "assets" / "face_topology.obj")
    shrink = [f"assets={tmp / 'assets'}"] + SHRINK
    jax_opts = shrink + ["model.raymarch.interpret=true"]
    res = {"jax": {}, "port": {}, "tmp": tmp}
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("AVA256_CACHE_DIR", str(tmp / "cache"))
        mp.delenv("AVA256_LPIPS_WEIGHTS", raising=False)
        mp.setattr(ava256_tpu.platform, "respect_env_platforms", lambda: None)
        mp.setattr(jax_train, "make_mesh", lambda axis_names=("data",): make_mesh(1, axis_names))
        for mod in (jax_eval, port_eval):  # the unrounded means
            mp.setattr(mod, "round", lambda x, n=None: x, raising=False)

        # ---- train ----
        # The JAX side's progress renders (two more compiles of the forward
        # in interpret mode) are left out; the port's are checked below.
        mp.setattr(jax_train, "_progress_render", lambda *a: None)
        mp.setattr(jax_train, "_xid_render", lambda *a: None)
        seen_jax, seen_port, saved = [], [], []
        save = jax_train.save_checkpoint
        mp.setattr(jax_train, "save_checkpoint",
                   lambda d, state, *a: (saved.append(state), save(d, state, *a))[1])
        mp.setattr(jax_train, "make_train_step", _recording(jax_train.make_train_step, seen_jax))
        mp.setattr(loop, "make_train_step", _recording(loop.make_train_step, seen_port))
        _run_script(jax_train, ["--config", CONFIG, f"progress.output_path={tmp / 'jax'}"]
                    + jax_opts)
        port_train.main(["--config", CONFIG, "--device", "cpu",
                         f"progress.output_path={tmp / 'port'}"] + shrink)
        res["jax"]["seen"], res["port"]["seen"] = seen_jax, seen_port

        # ---- the JAX checkpoint, restored and converted ----
        cfg = load_config(CONFIG, shrink)
        jstate = restore_checkpoint(str(tmp / "jax" / "checkpoints"), saved[-1])
        tree = jax.tree_util.tree_map(np.asarray, jstate.as_dict())
        ds = loop.build_dataset(cfg)
        model = loop.build_model(cfg, ds, loop.load_uvdata(cfg), "cpu")
        state = load_train_state(TrainState(model, make_optimizer(model), 0), tree)
        save_checkpoint(tmp / "converted", state)

        # ---- eval, render, id-cond over the same weights ----
        # (the JAX scripts' init_model only shapes the restore template: the
        # trained variables stand in for it, which saves a compile each)
        def variables(*a):
            return {"params": saved[-1].params, "stats": saved[-1].stats}

        mp.setattr(jax_eval, "init_model", variables)
        mp.setattr(ava256_tpu.train.init, "init_model", variables)
        common = ["--config", CONFIG]
        res["jax"]["eval"] = _json_line(_run_script(jax_eval, common + [
            "--checkpoint", str(tmp / "jax" / "checkpoints"), "--holdout-cameras", "1",
            "--num-items", "2", "--opts"] + jax_opts))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            port_eval.main(common + ["--device", "cpu", "--checkpoint", str(tmp / "converted"),
                                     "--holdout-cameras", "1", "--num-items", "2", "--opts"]
                           + shrink)
        res["port"]["eval"] = _json_line(out.getvalue())
        _run_script(jax_render, common + [
            "--checkpoint", str(tmp / "jax" / "checkpoints"), "--num-frames", "1",
            "--output", str(tmp / "jax_renders"), "--opts"] + jax_opts)
        port_render.main(common + ["--device", "cpu", "--checkpoint", str(tmp / "converted"),
                                   "--num-frames", "1", "--output", str(tmp / "port_renders"),
                                   "--opts"] + shrink)
        _run_script(jax_idc, common + [
            "--checkpoint", str(tmp / "jax" / "checkpoints"), "--output",
            str(tmp / "jax_idc"), "--opts"] + jax_opts)
        port_idc.main(common + ["--device", "cpu", "--checkpoint", str(tmp / "converted"),
                                "--output", str(tmp / "port_idc"), "--opts"] + shrink)
    finally:
        mp.undo()
    return res


def test_train_consumes_the_same_batches_without_held_out_cameras(runs):
    jax_seen, port_seen = runs["jax"]["seen"], runs["port"]["seen"]
    assert len(jax_seen) == len(port_seen) == 2
    assert [s[:2] for s in port_seen] == [s[:2] for s in jax_seen]
    assert all(c < 2 for s in port_seen for c in s[1])  # camera 2 of 3 is held out
    # the port's steps get the device tables and a lean batch, as the JAX ones
    for (_, _, jcond, jkeys), (_, _, cond, keys) in zip(jax_seen, port_seen):
        assert jcond and cond and keys == jkeys == ["camindex", "idindex", "image", "verts"]


def test_train_writes_the_same_files(runs):
    tmp = runs["tmp"]
    assert (tmp / "jax" / "timesinfo_r0.npy").is_file()
    # [gt, rec, err] per batch element; [gt, self, identity 0 unless it is the own one]
    assert _png(tmp / "port" / "progress_0.png").shape == (64, 96, 3)
    own = runs["port"]["seen"][0][0][0]
    assert _png(tmp / "port" / "x-id" / "progress_0.png").shape == (32, 64 + 32 * (own != 0), 3)
    assert sorted(p.name for p in (tmp / "port" / "checkpoints").iterdir()) == \
        ["step_00000002.pt"]
    info = np.load(tmp / "port" / "timesinfo_r0.npy", allow_pickle=True).item()
    ref = np.load(tmp / "jax" / "timesinfo_r0.npy", allow_pickle=True).item()
    assert info.keys() == ref.keys() and info["steps"] == ref["steps"] == 2


def test_eval_matches_jax(runs):
    got, ref = runs["port"]["eval"], runs["jax"]["eval"]
    assert got.keys() == ref.keys() and "lpips_rf" in got
    assert (got["split"], got["items"], got["checkpoint_step"]) == ("heldout_cameras", 2, 2)
    assert (ref["split"], ref["items"], ref["checkpoint_step"]) == ("heldout_cameras", 2, 2)
    for k in ("psnr_db", "ssim", "lpips_rf"):
        assert abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k]), (k, got[k], ref[k])


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path)).astype(np.int32)


def test_render_matches_jax(runs):
    tmp = runs["tmp"]
    names = sorted(os.listdir(tmp / "jax_renders"))
    assert names == sorted(os.listdir(tmp / "port_renders")) == ["render_0000.png"]
    got, ref = _png(tmp / "port_renders" / names[0]), _png(tmp / "jax_renders" / names[0])
    assert got.shape == ref.shape == (32, 96, 3)
    assert np.abs(got - ref).max() <= 3 and np.abs(got - ref).mean() < 0.05


def test_generate_id_cond_matches_jax(runs):
    tmp = runs["tmp"]
    names = sorted(os.listdir(tmp / "jax_idc"))
    assert names == sorted(os.listdir(tmp / "port_idc")) == ["id000.pkl", "id001.pkl"]
    for name in names:
        with open(tmp / "port_idc" / name, "rb") as f:
            got = pickle.load(f)
        with open(tmp / "jax_idc" / name, "rb") as f:
            ref = pickle.load(f)
        assert got.keys() == ref.keys() == {"z_geo", "z_tex", "b_geo", "b_tex"}
        pairs = [(got[k], ref[k]) for k in ("z_geo", "z_tex")]
        for k in ("b_geo", "b_tex"):
            assert isinstance(got[k], list) and len(got[k]) == len(ref[k])
            pairs += list(zip(got[k], ref[k]))
        for g, r in pairs:
            assert isinstance(g, np.ndarray) and g.shape == r.shape and g.dtype == r.dtype
            assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max() + 1e-6
