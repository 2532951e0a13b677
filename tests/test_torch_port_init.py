# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The port's own initialization (``factory.get_autoencoder``, the layers'
``_init_params``) against the JAX package's ``init_model``, parameter by
parameter, at the tier-1 size of ``tests/test_torch_port_trajectory.py``
(every layer kind of the flagship: weight-normalized dense, conv and
blockwise transposed-conv layers, plain dense and conv layers, biases,
embeddings and the zero-initialized slabs). The two draw from different
generators, so they agree in distribution, not in values:

- the same names, shapes and dtypes, buffers included;
- a weight with at least ``MIN_SIZE`` entries: its std within ``STD_SHARE``
  of JAX's, its largest |w| within the Xavier bound both draw under and
  within ``MAX_SHARE`` of JAX's; every weight's mean within 4 standard errors
  of 0;
- a transposed conv whose kernel is a multiple of its stride: the kernel
  constant over each stride-parity block, in both packages;
- each weight-norm ``g``: every entry equal to the Frobenius norm of its own
  weight, as JAX initializes it (to 1e-5: a float32 sum of up to 2^19
  squares against the float64 norm);
- every other parameter and buffer (biases, slabs, colour calibration,
  ``adaptwarps``): equal to JAX's.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ava256_tpu_torch.convert import flax_to_state_dict  # noqa: E402
from ava256_tpu_torch.ops.layers import ConvTranspose2dWN  # noqa: E402

from tests import _torch_port_threads  # noqa: E402,F401
from tests.test_torch_port_trajectory import (  # noqa: E402
    TINY, Inputs, JaxArm, PortArm)

MIN_SIZE = 1024
STD_SHARE, MAX_SHARE = 0.1, 0.1


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    inp = Inputs(tmp_path_factory.mktemp("init"), TINY)
    jarm = JaxArm(inp)
    port = PortArm(inp, None, "P-own").model
    return port, flax_to_state_dict(jarm.variables, port), port.state_dict()


def _weights(port):
    """(name, module) of every weight the factory draws at random."""
    return [(f"{m}.weight" if m else "weight", mod) for m, mod in port.named_modules()
            if isinstance(getattr(mod, "weight", None), torch.nn.Parameter)]


def test_same_names_shapes_and_dtypes(both):
    _, ref, own = both
    assert set(own) == set(ref)
    for k, v in own.items():
        assert v.shape == ref[k].shape and v.dtype == ref[k].dtype, k


def test_weights_follow_the_same_distribution(both):
    port, ref, own = both
    checked = 0
    for name, _ in _weights(port):
        a, b = ref[name].double(), own[name].double()
        n = b.numel()
        # the uniform's bound, from the entries of both draws
        bound = float(max(a.abs().max(), b.abs().max()))
        assert abs(float(b.mean())) <= 4 * bound / np.sqrt(3 * n), name
        if n < MIN_SIZE:
            continue
        assert abs(float(b.std()) - float(a.std())) <= STD_SHARE * float(a.std()), name
        assert abs(float(b.abs().max()) - float(a.abs().max())) <= MAX_SHARE * float(
            a.abs().max()), name
        checked += 1
    assert checked >= 40, checked


def test_transposed_convs_are_blockwise(both):
    port, ref, own = both
    seen = 0
    for name, mod in _weights(port):
        if not isinstance(mod, ConvTranspose2dWN):
            continue
        (sh, sw), (kh, kw) = mod.stride, mod.weight.shape[2:]
        if kh % sh or kw % sw or sh * sw == 1:
            continue
        for w in (own[name], ref[name]):
            blocks = w.reshape(*w.shape[:2], kh // sh, sh, kw // sw, sw)
            assert torch.equal(blocks, blocks[:, :, :, :1, :, :1].expand_as(blocks)), name
        seen += 1
    assert seen >= 4, seen


def test_g_is_the_norm_of_its_weight(both):
    port, ref, own = both
    seen = 0
    for name, _ in _weights(port):
        g = name[:-len("weight")] + "g"
        if g not in own:
            continue
        for sd in (own, ref):
            norm = float(torch.sqrt(torch.sum(sd[name].double() ** 2)))
            np.testing.assert_allclose(sd[g].numpy(), norm, rtol=1e-5, err_msg=g)
        seen += 1
    assert seen >= 40, seen


def test_every_other_parameter_and_buffer_is_jax_s(both):
    port, ref, own = both
    drawn = {n for n, _ in _weights(port)}
    drawn |= {n[:-len("weight")] + "g" for n in drawn}
    rest = [k for k in ref if k not in drawn]
    assert any(k.endswith(".bias") for k in rest) and "decoder_assembler.adaptwarps" in rest
    for k in rest:
        assert torch.equal(own[k], ref[k]), k
