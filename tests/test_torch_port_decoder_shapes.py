# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The decoder at the shapes the configurations train, against the JAX
package on the CPU: 16,384 primitives of 8^3 (the flagship and config-4:
the adaptive EMA scale) and 262,144 of 2^3
(``configs/config-synthetic-262k.yaml``: the table scale 128.0 and a motion
field of nh = 512), each with 1024^2 textures and its full decoder towers.

The port's model is initialized from its seed, its weights perturbed with
seeded numpy noise and carried into the JAX model's tree (the inverse of
``convert.flax_to_state_dict``, checked by converting back). One item, 16x16
rays (the march has its own tests). The forward's ``march_inputs``
(``output_set={"march_inputs"}``: rays, primitive positions, rotations,
scales and templates) and the decoded vertices, first with
``running_avg_scale=True`` from a zero ``adaptwarps``, then without it from
the buffer that forward left: max |d| <= 1e-4 max |ref| + 1e-4, and
``adaptwarps`` to the same.

One input differs by design: the rotations at 262,144 primitives. Their
frames come from the position map's forward differences at each 2x2
block's centre texel c = 1, which reach into the next block. The JAX
package takes them inside the block, where the index c + 1 = 2 clamps to
c: its differences, frames and ``primrot`` are zero there. The port takes
the differences across blocks (``tbn_frames``, the reference's semantics):
its ``primrot`` are held to be rotations, and ``tbn_frames`` to a numpy
restatement of the reference's differences at 2x2 blocks (across blocks)
and at 8x8 (inside them, where the JAX package's block form agrees).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ava256_tpu_torch.convert import flax_to_state_dict
from ava256_tpu_torch.data.synthetic import SyntheticDataset, none_collate, synthetic_uvdata
from ava256_tpu_torch.factory import get_autoencoder
from ava256_tpu_torch.models.decoders.assembler import tbn_frames
from ava256_tpu_torch.ops.layers import Conv2d, Conv2dWN, ConvTranspose2dWN, Linear, LinearWN

from tests import _torch_port_threads  # noqa: F401
from ava256_tpu.train.step import BATCH_MODEL_KEYS

CASES = {"16384x8^3": (16384, 8), "262144x2^3": (262144, 2)}
TEXSIZE, RAYS = 1024, 16
OPTS = {"tile": 16, "max_hit": 8, "nbuf": 32, "dt": 16.0}
MARCH_KEYS = ("raypos", "raydir", "tminmax", "primpos", "primrot", "primscale", "template")


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    lim = 1e-4 * np.abs(ref).max() + 1e-4
    assert err <= lim, f"{what}: max|d| {err:.3g} > {lim:.3g}"


def _to_flax_layout(module, leaf: str, x: np.ndarray) -> np.ndarray:
    """The inverse of ``convert._to_torch_layout``."""
    if leaf != "weight":
        return x
    if isinstance(module, (Conv2dWN, Conv2d)):
        return x.transpose(2, 3, 1, 0)
    if isinstance(module, ConvTranspose2dWN):
        return x.transpose(2, 3, 0, 1)[::-1, ::-1]
    if isinstance(module, (LinearWN, Linear)):
        return x.T
    return x


def _flax_tree(shapes, port) -> dict:
    """The port's state_dict as a flax tree of the structure ``shapes``."""
    sd = port.state_dict()

    def fill(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: fill(v, path + (k,)) for k, v in node.items()}
        key = ".".join(path[1:])
        owner, _, leaf = key.rpartition(".")
        x = _to_flax_layout(port.get_submodule(owner), leaf, sd[key].numpy())
        assert x.shape == tuple(node.shape), (key, x.shape, node.shape)
        return np.ascontiguousarray(x)

    return fill(shapes, ())


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    from __graft_entry__ import _build

    nprims, primsize = CASES[request.param]
    model, mb, _ = _build(texsize=TEXSIZE, nprims=nprims, height=RAYS, width=RAYS, batch=1,
                          nident=1, ncams=1, primsize=primsize, raymarch_backend="pallas",
                          raymarch_options=dict(OPTS, interpret=True))
    ds = SyntheticDataset(nident=1, ncams=1, height=RAYS, width=RAYS, texsize=TEXSIZE)
    port = get_autoencoder(synthetic_uvdata(TEXSIZE), ds.vertmean, ds.vertstd, ncams=1,
                           nident=1, nprims=nprims, primsize=(primsize,) * 3,
                           raymarch_options=OPTS, device="cpu", seed=0)
    rng = np.random.RandomState(7)
    with torch.no_grad():
        for p in port.parameters():  # no zero biases or unit gains to rest on
            x = p.numpy()
            p.add_(torch.from_numpy((0.05 * (np.abs(x).mean() + 0.1)
                                     * rng.randn(*x.shape)).astype(np.float32)))
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda k, b: model.init(
        {"params": k, "sample": k}, target_neut_avgtex=b["neut_avgtex"],
        target_neut_verts=b["neut_verts"], idindex=b["idindex"], camindex=b["camindex"],
        **{n: b[n] for n in BATCH_MODEL_KEYS}), key, mb)
    tree = _flax_tree(dict(shapes), port)
    back = flax_to_state_dict(tree, port)
    assert all(torch.equal(back[k], v) for k, v in port.state_dict().items())

    def forward(v, b, running_avg_scale):
        return model.apply(v, target_neut_avgtex=b["neut_avgtex"],
                           target_neut_verts=b["neut_verts"], idindex=b["idindex"],
                           camindex=b["camindex"], deterministic=True,
                           running_avg_scale=running_avg_scale, mutable=["stats"],
                           output_set=frozenset({"march_inputs"}),
                           **{n: b[n] for n in BATCH_MODEL_KEYS})

    @jax.jit
    def both(v, b):
        on, mut = forward(v, b, True)
        off, _ = forward({"params": v["params"], "stats": mut["stats"]}, b, False)
        return on, off, mut["stats"]

    on, off, stats = both(jax.tree_util.tree_map(jnp.asarray, tree), mb)
    item = none_collate([ds[0]])
    tb = {k: torch.from_numpy(np.asarray(item[k])) for k in mb}
    return dict(port=port, tb=tb, jax={"on": on, "off": off},
                adaptwarps=np.asarray(stats["decoder_assembler"]["adaptwarps"]))


def _forward(port, tb, running_avg_scale):
    with torch.no_grad():
        return port(target_neut_avgtex=tb["neut_avgtex"], target_neut_verts=tb["neut_verts"],
                    idindex=tb["idindex"], camindex=tb["camindex"], deterministic=True,
                    running_avg_scale=running_avg_scale, output_set=frozenset({"march_inputs"}),
                    **{k: tb[k] for k in BATCH_MODEL_KEYS})


@pytest.mark.parametrize("running_avg_scale", [True, False], ids=["running_avg", "stats"])
def test_march_inputs_match_jax(case, running_avg_scale):
    port, tb = case["port"], case["tb"]
    aw = port.decoder_assembler.adaptwarps
    adaptive = aw.shape[0] == 16384
    if running_avg_scale:
        aw.zero_()
    elif adaptive and not aw.any():  # run alone: the warm-up forward first
        _forward(port, tb, True)
    out = _forward(port, tb, running_avg_scale)
    ref = case["jax"]["on" if running_avg_scale else "off"]
    _close(out["verts"].numpy(), ref["verts"], "verts")
    got, want = out["march_inputs"], ref["march_inputs"]
    for k in MARCH_KEYS:
        if k == "primrot" and not adaptive:
            # the JAX frames at 2^3 are zero (its block index c + 1 = 2
            # clamps to c); the port's are rotations (test_frames_*)
            assert not np.asarray(want[k]).any()
            rot = got[k].double()
            eye = torch.eye(3, dtype=torch.float64).expand_as(rot)
            assert float((rot.transpose(-1, -2) @ rot - eye).abs().max()) < 1e-4
            continue
        _close(got[k].numpy().reshape(np.shape(want[k])), want[k], k)
    assert float(got["stepsize"]) == pytest.approx(float(want["stepsize"]))
    _close(aw.numpy(), case["adaptwarps"], "adaptwarps")
    if adaptive:  # the EMA scale, set by the warm-up forward
        assert float(aw.min()) > 0
    else:  # the table scale (128.0) of 262,144 primitives
        assert not aw.any() and float(got["primscale"].min()) > 0


def _frames_numpy(postex: np.ndarray, s: int) -> np.ndarray:
    """TBN frames at the block centres from the full map's forward
    differences, the last one duplicated (as the reference computes them)."""
    du = np.concatenate([postex[:, :, 1:] - postex[:, :, :-1],
                         postex[:, :, -1:] - postex[:, :, -2:-1]], axis=2)
    dv = np.concatenate([postex[:, 1:] - postex[:, :-1], postex[:, -1:] - postex[:, -2:-1]],
                        axis=1)
    c = s // 2
    du, dv = du[:, c::s, c::s], dv[:, c::s, c::s]

    def unit(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-8)

    t = unit(du)
    nrm = unit(np.cross(t, dv))
    b = unit(np.cross(nrm, t))
    return np.stack([t, b, nrm], axis=-1).reshape(postex.shape[0], -1, 3, 3)


@pytest.mark.parametrize("s", [2, 8])
def test_frames_from_forward_differences(s):
    nh = 6
    postex = np.random.RandomState(s).randn(2, nh * s, nh * s, 3).astype(np.float32)
    got = tbn_frames(torch.from_numpy(postex), nh, s)
    np.testing.assert_allclose(got.numpy(), _frames_numpy(postex.astype(np.float64), s),
                               rtol=1e-5, atol=1e-5)
