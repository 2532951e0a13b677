# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""CUDA graphs for the decode's modules (``ops/graphs.py`` ``GraphCache``).

On the CPU the cache's logic runs with a stand-in for the capture
(``FakeCapture``: its replay reruns the forward on the static inputs and
writes the static outputs in place, as a graph's replay overwrites its
memory): a signature is captured at its second sighting; grad mode, CPU
tensors, the assembler's scale update and a given ``gt_geo`` run eagerly;
a replaced parameter gives a new signature and a loaded one does not; the
LRU cap holds; a failed capture falls back to eager and is counted; an
argument that cannot be hashed runs eagerly; a replay adds to the kernel
wrappers' launch counts what its capture recorded; the three modules give
bitwise the outputs of their eager forward.

The real graphs are held to the eager decode on the card by
``tests/test_torch_port_cuda.py`` (``test_graphed_decode_*`` and the tests
after it).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

from ava256_tpu_torch.ops import graphs
from ava256_tpu_torch.ops.graphs import GraphCache
from ava256_tpu_torch.render import decode

from _graph_cases import FRAMES_3, GRAPHED, tensors, warm_scene
from tests import _torch_port_threads  # noqa: F401

TINY = dict(batch=1, height=8, width=8, nprims=256, texsize=64, primsize=16,
            raymarch_options={"tile": 8, "max_hit": 4, "nbuf": 16, "dt": 16.0})


class FakeCapture:
    """Stands in for ``capture_cuda`` on the CPU."""

    def __init__(self, fail: bool = False):
        self.calls, self.fail = 0, fail

    def __call__(self, run, device):
        self.calls += 1
        if self.fail:
            raise RuntimeError("capture refused")
        run()  # the warm-up
        with graphs.recorded() as gains:
            out = run()

        def replay():
            with graphs.recorded():  # the cache adds the recorded gains
                new = run()
            for static, x in zip(tensors(out), tensors(new)):
                static.copy_(x)

        return replay, out, gains


def fake_cache(**kw) -> GraphCache:
    return GraphCache(capture=kw.pop("capture", FakeCapture()), device_type="cpu", **kw)


class Launches:
    """A kernel wrapper's launch count."""

    def __init__(self):
        self.launches = 0


class Toy(nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.lin = nn.Linear(4, 3)
        self.graphs = fake_cache()
        self.kernel = Launches()

    def forward(self, x, scale=1.0, pure=True):
        return self.graphs(self, self._forward, x, scale=scale, pure=pure)

    def _forward(self, x, scale=1.0, pure=True):
        self.kernel.launches += 2
        return {"y": [self.lin(x) * float(scale)], "z": x.sum(-1)}


def _equal(a, b) -> bool:
    la, lb = tensors(a), tensors(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _counts(cache: GraphCache):
    return dataclasses.astuple(cache.counts)


def test_second_sighting_captures():
    toy, x = Toy(), torch.randn(2, 4)
    with torch.inference_mode():
        want = toy._forward(x)
        outs = [toy(x) for _ in range(3)]
    assert _counts(toy.graphs) == (1, 2, 1, 0)
    assert toy.graphs.capture.calls == 1
    assert all(_equal(o, want) for o in outs)
    # each call's outputs are its own: nothing aliases the graph's memory
    assert outs[1]["y"][0].data_ptr() != outs[2]["y"][0].data_ptr()


@pytest.mark.parametrize("how", ["grad", "no_grad", "cpu_tensors_on_a_cuda_cache", "impure"])
def test_gating_sends_to_eager(how):
    toy, x = Toy(), torch.randn(2, 4)
    if how == "cpu_tensors_on_a_cuda_cache":
        toy.graphs = GraphCache(capture=FakeCapture())
    for _ in range(3):
        if how == "grad":
            out = toy(x)
            assert out["y"][0].requires_grad
        elif how == "no_grad":
            with torch.no_grad():
                out = toy(x)
        else:
            with torch.inference_mode():
                out = toy(x, pure=how != "impure")
        assert _equal(out, toy._forward(x))
    assert _counts(toy.graphs) == (0, 0, 3, 0)
    assert not toy.graphs.entries and toy.graphs.capture.calls == 0


def test_a_replaced_parameter_is_a_new_signature_a_loaded_one_is_not():
    toy, x = Toy(), torch.randn(2, 4)
    with torch.inference_mode():
        toy(x), toy(x)
        assert _counts(toy.graphs) == (1, 1, 1, 0)
        state = {k: v * 2.0 for k, v in toy.state_dict().items()}
    toy.load_state_dict(state)  # copied into the same tensors
    with torch.inference_mode():
        out = toy(x)
        assert _counts(toy.graphs) == (1, 2, 1, 0)
        assert _equal(out, toy._forward(x))
    toy.lin.weight = nn.Parameter(toy.lin.weight.detach().clone() + 1.0)
    with torch.inference_mode():
        first, second = toy(x), toy(x)
        want = toy._forward(x)
    assert _counts(toy.graphs) == (2, 3, 2, 0)
    assert _equal(first, want) and _equal(second, want)


def test_the_lru_cap_holds():
    toy, n = Toy(), graphs.MAX_SIGNATURES + 1
    xs = [torch.randn(b, 4) for b in range(1, n + 1)]
    with torch.inference_mode():
        for x in xs:
            toy(x), toy(x)
        assert len(toy.graphs.entries) == n - 1
        assert _counts(toy.graphs) == (n, n, n, 0)
        out = toy(xs[0])  # evicted: seen anew, so eager
        assert _counts(toy.graphs) == (n, n, n + 1, 0)
        assert _equal(out, toy._forward(xs[0]))
        toy(xs[-1])  # still held: a replay
    assert _counts(toy.graphs) == (n, n + 1, n + 1, 0)
    assert len(toy.graphs.entries) == n - 1


@pytest.mark.parametrize("why", ["capture_raises", "input_overlaps"])
def test_a_failed_capture_runs_eagerly_and_is_counted(why):
    toy = Toy()
    toy.graphs = fake_cache(capture=FakeCapture(fail=why == "capture_raises"))
    x = torch.randn(1, 4).expand(3, 4) if why == "input_overlaps" else torch.randn(3, 4)
    with torch.inference_mode():
        outs = [toy(x) for _ in range(4)]
        want = toy._forward(x)
    assert _counts(toy.graphs) == (0, 0, 4, 1)
    assert toy.graphs.capture.calls == (1 if why == "capture_raises" else 0)
    assert all(_equal(o, want) for o in outs)


def test_outputs_survive_the_next_call():
    toy = Toy()
    a, b = torch.randn(2, 4), torch.randn(2, 4)
    with torch.inference_mode():
        toy(a)
        first = toy(a)  # captured and replayed
        kept = copy.deepcopy(first)
        toy(b)
    assert _equal(first, kept)


def test_a_replay_counts_the_launches_its_capture_recorded():
    """The capture's recorded run is taken back from the kernel wrapper's
    count and each replay adds it: the count is the launches made, the
    capture's warm-up included."""
    toy, x = Toy(), torch.randn(2, 4)
    graphs.count_launches(toy.kernel, "launches")
    with torch.inference_mode():
        toy(x)  # eager: 2
        assert toy.kernel.launches == 2
        toy(x)  # captured (a warm-up, 2; a recorded run, 0) and replayed, 2
        assert toy.kernel.launches == 6
        toy(x)
    assert toy.kernel.launches == 8
    assert _counts(toy.graphs) == (1, 2, 1, 0)
    assert toy.graphs.entries[next(reversed(toy.graphs.entries))].gains == [
        (toy.kernel, "launches", 2)]


def test_an_argument_that_cannot_be_hashed_runs_eagerly():
    class Scale:
        __hash__ = None

        def __float__(self):
            return 2.0

    toy, x, scale = Toy(), torch.randn(2, 4), Scale()
    with torch.inference_mode():
        outs = [toy(x, scale=scale) for _ in range(3)]
        want = toy._forward(x, scale=scale)
    assert _counts(toy.graphs) == (0, 0, 3, 0) and not toy.graphs.entries
    assert all(_equal(o, want) for o in outs)


# --- the decode's three modules ---------------------------------------------


@pytest.fixture(scope="module")
def scene():
    return warm_scene("cpu", **TINY)


def _module_calls(model, mb, tex, verts):
    """The three modules' arguments as ``Autoencoder.forward`` passes them."""
    with torch.inference_mode():
        id_cond = model.identity_encoder._forward(verts, tex)
        expr = model.expression_encoder._forward(mb["verts"], mb["avgtex"], mb["neut_verts"],
                                                 mb["neut_avgtex"])
        code = model.bottleneck(expr, deterministic=True)[0]
    mm = mb["modelmatrix"]
    viewpos = torch.einsum("ni,nij->nj", mb["campos"] - mm[:, :3, 3], mm[:, :3, :3])
    return {"identity_encoder": ((verts, tex), {}),
            "expression_encoder": ((mb["verts"], mb["avgtex"], mb["neut_verts"],
                                    mb["neut_avgtex"]), {}),
            "decoder_assembler": ((id_cond, code, viewpos), {})}


@pytest.mark.parametrize("name", GRAPHED)
def test_module_cpu_outputs_are_their_eager_forwards(scene, name):
    """On the CPU the module's own cache never engages and its output is its
    eager forward's, bit for bit; with the stand-in capture, so are the
    replays'."""
    model, mb, tex, verts = scene
    mod = getattr(model, name)
    args, kwargs = _module_calls(model, mb, tex, verts)[name]
    with torch.inference_mode():
        want = mod._forward(*args, **kwargs)
        assert _equal(mod(*args, **kwargs), want)
    assert not mod.graphs.entries and mod.graphs.counts.captures == 0
    own = mod.graphs
    mod.graphs = fake_cache()
    try:
        with torch.inference_mode():
            outs = [mod(*args, **kwargs) for _ in range(3)]
        assert _counts(mod.graphs) == (1, 2, 1, 0)
        assert all(_equal(o, want) for o in outs)
    finally:
        mod.graphs = own


@pytest.mark.parametrize("flag", ["running_avg_scale", "gt_geo"])
def test_the_assembler_keeps_the_scale_update_and_gt_geo_eager(scene, flag):
    model = copy.deepcopy(scene[0])
    _, mb, tex, verts = scene
    asm = model.decoder_assembler
    asm.graphs = fake_cache()
    (id_cond, code, viewpos), _ = _module_calls(model, mb, tex, verts)["decoder_assembler"]
    kw = {"running_avg_scale": True} if flag == "running_avg_scale" else {"gt_geo": mb["verts"]}
    with torch.inference_mode():
        for _ in range(3):
            asm(id_cond, code, viewpos, **kw)
    assert _counts(asm.graphs) == (0, 0, 3, 0) and not asm.graphs.entries


def test_decode_with_graphs_matches_eager(scene):
    """``cli.render``'s frames through the three modules' graphs (the
    stand-in capture), self- and cross-driven, against the eager decode;
    ``report`` gives each module's counts."""
    assert scene[2].stride() != scene[1]["neut_avgtex"].stride()
    model, mb, tex, verts = scene
    targets = ((mb["neut_avgtex"], mb["neut_verts"]), (tex, verts))
    want = [decode(model, mb, *t) for t in targets]
    own = {name: getattr(model, name).graphs for name in GRAPHED}
    for name in GRAPHED:
        getattr(model, name).graphs = fake_cache()
    try:
        got = [decode(model, mb, *t) for _ in range(3) for t in targets]
        counts = graphs.report(model)
    finally:
        for name, cache in own.items():
            getattr(model, name).graphs = cache
    for i, image in enumerate(got):
        np.testing.assert_array_equal(image.numpy(), want[i % 2].numpy())
    assert set(counts) == set(GRAPHED)
    for name in GRAPHED:
        captures, replays = FRAMES_3[name]
        assert counts[name] == {"captures": captures, "replays": replays,
                                "eager": 6 - replays, "failed": 0}, name
