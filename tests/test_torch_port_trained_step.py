# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""One training step of the port against the JAX package at trained weights:
the expression latent open (KL about 5) and the global-norm clip active,
where every earlier parity test started at initial weights with KL about 0.

The state is made at the tier-1 size of ``tests/test_torch_port_trajectory.py``
(the kernels' path of both packages): JAX's initial weights with the
bottleneck pushed to trained magnitudes (the ``g`` of ``bottleneck.mu``
scaled until |mu| has an rms of ``MU_RMS``, so KL is about MU_RMS^2 / 2; the
``g`` of ``bottleneck.logstd`` scaled to an rms of ``LOGSTD_RMS`` about a
mean of ``LOGSTD_MEAN``, through its bias), then ``PRE_STEPS`` JAX steps, so
Adam's moments are those of a run. From that state both packages take step
``PRE_STEPS`` with the same batch and noise:

- the bottleneck's mu and logstd, every loss term: 1e-4 relative;
- every parameter group's gradient (before the clip): cosine > 0.9999 and
  norm ratio within 1e-3 of 1;
- the clip's scale factor: 1e-4 relative;
- the update of every group and of all the ``g``s: cosine > 0.9999 and norm
  ratio within 1e-3; ``adaptwarps``: 1e-4 of its largest value.
"""

import json
import os
import sys
import tempfile

import numpy as np
import pytest

if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests import _torch_port_threads  # noqa: E402,F401
from tests.test_torch_port_trajectory import (  # noqa: E402
    GROUPS, TERMS, TINY, Inputs, JaxArm, compare_trained_step, jax_train_state,
    saved_state, trained_step_report)

MU_RMS = 3.0
LOGSTD_RMS, LOGSTD_MEAN = 0.2, -0.3
PRE_STEPS = 3


def _push_bottleneck(jarm: JaxArm, inp: Inputs):
    """JAX's initial variables with the bottleneck's heads scaled to trained
    magnitudes on the first batch."""
    tree = jax.tree_util.tree_map(np.array, jarm.variables)
    b = {k: jnp.asarray(v) for k, v in inp.batch(0).items()}
    _, mu, logstd = (np.asarray(x, np.float64) for x in jarm._encode(tree, b))
    bott = tree["params"]["bottleneck"]
    bott["mu"]["g"] *= np.float32(MU_RMS / np.sqrt(np.mean(mu**2)))
    bott["logstd"]["g"] *= np.float32(LOGSTD_RMS / np.sqrt(np.mean(logstd**2)))
    bott["logstd"]["bias"] += np.float32(LOGSTD_MEAN / 0.01)  # logstd = 0.01 (conv + bias)
    return tree


def trained_step(workdir):
    """The comparison and its report, from the pushed and trained state."""
    inp = Inputs(workdir, TINY)
    jarm = JaxArm(inp)
    tree = _push_bottleneck(jarm, inp)
    state = jax_train_state(jarm, dict(tree, opt_state=jarm.tx.init(tree["params"]), step=0))
    for i in range(PRE_STEPS):
        b = {k: jnp.asarray(v) for k, v in inp.batch(i).items()}
        state, _, _ = jarm.step_fn(state, b, jax.random.fold_in(jax.random.PRNGKey(0), i),
                                   cond=None, **inp.flags(i))
    saved = saved_state(state, PRE_STEPS, inp.batch(PRE_STEPS),
                        jarm.noise(PRE_STEPS, inp.batch(PRE_STEPS)))
    r = compare_trained_step(inp, jarm, saved)
    return r, trained_step_report(r)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return trained_step(tmp_path_factory.mktemp("trained_step"))


def test_the_state_is_trained(trained):
    """KL at least 1 (about 5), mu of a few units and the clip active."""
    r, rep = trained
    assert 1.0 <= rep["jterms"]["kldiv"] <= 20.0, rep["jterms"]
    assert np.sqrt(np.mean(r["jmu"] ** 2)) > 1.0
    assert rep["clip_scale"]["jax"] < 0.5, rep["clip_scale"]


def test_forward_and_loss_terms_match(trained):
    r, rep = trained
    for a, b in ((r["pmu"], r["jmu"]), (r["plogstd"], r["jlogstd"])):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    for k in TERMS:
        assert abs(rep["pterms"][k] - rep["jterms"][k]) <= 1e-4 * abs(rep["jterms"][k]), k


@pytest.mark.parametrize("group", GROUPS)
def test_gradients_match_by_group(trained, group):
    _, rep = trained
    cos, ratio, norm = rep["grads"][group]
    assert norm > 0.0
    assert cos > 0.9999 and abs(ratio - 1.0) <= 1e-3, (cos, ratio)


def test_clip_scale_matches(trained):
    _, rep = trained
    c = rep["clip_scale"]
    assert abs(c["port"] - c["jax"]) <= 1e-4 * c["jax"], c


@pytest.mark.parametrize("group", GROUPS + ("g",))
def test_updates_match(trained, group):
    """Adam's update of each group, and of every weight-norm ``g``, after
    the clip."""
    _, rep = trained
    cos, ratio, norm = rep["updates"][group]
    assert norm > 0.0
    assert cos > 0.9999 and abs(ratio - 1.0) <= 1e-3, (cos, ratio)


def test_running_average_scale_matches(trained):
    _, rep = trained
    assert rep["adaptwarps_max_rel"] <= 1e-4


if __name__ == "__main__":
    # the report the tests read: python tests/test_torch_port_trained_step.py
    with tempfile.TemporaryDirectory() as tmp:
        print(json.dumps(trained_step(tmp)[1], indent=1))
