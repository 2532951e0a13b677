# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The port's spans on the frame path (``train/profiling.py`` ``annotate``),
on the CPU with a tiny model and the kernels' plain versions:

- under ``torch.profiler`` one frame as ``cli.render`` decodes it (collate,
  upload, a self-driven and a cross-driven decode) records ``ava:collate``,
  ``ava:upload``, two ``ava:decode`` spans, and in each decode one
  ``ava:raymarch`` with one ``ava:raymarch.cull`` inside it;
- with no profiler recording, no span enters ``record_function`` (patched
  to raise here), and the decode gives the same image;
- spans nest, and ``train_step``'s span goes through the same helper;
- a two-stage cull opens ``ava:raymarch.cull.groups`` then
  ``ava:raymarch.cull.members`` inside ``ava:raymarch.cull``, a dense one
  neither; under a profiler a two-stage cull adds to ``CULL_COUNTS`` what
  its own results count, and without one it counts nothing.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from ava256_tpu_torch import bench
from ava256_tpu_torch.data.dataset import none_collate
from ava256_tpu_torch.data.loader import Uploader
from ava256_tpu_torch.data.synthetic import raymarch_scene
from ava256_tpu_torch.ops import raymarch_cuda as rc
from ava256_tpu_torch.ops.math3d import rodrigues
from ava256_tpu_torch.render import BATCH_MODEL_KEYS, decode
from ava256_tpu_torch.train.loop import to_model_batch
from ava256_tpu_torch.train.profiling import annotate

from tests import _torch_port_threads  # noqa: F401

TINY = dict(batch=1, height=8, width=8, nprims=256, texsize=64, primsize=16,
            raymarch_options={"tile": 8, "max_hit": 4, "nbuf": 16, "dt": 16.0})
FRAME_SPANS = ("ava:collate", "ava:upload", "ava:decode", "ava:raymarch", "ava:raymarch.cull")
CULL_STAGES = ("ava:raymarch.cull.groups", "ava:raymarch.cull.members")


@pytest.fixture(scope="module")
def scene():
    """The tiny model with its primitives scaled by one warm-up forward (as
    the render benchmark's set-up does), the dataset, and another
    identity's neutral texture and vertices."""
    torch.manual_seed(0)
    model, mb, ds = bench.build(device="cpu", **TINY)
    with torch.inference_mode():
        model(target_neut_avgtex=mb["neut_avgtex"], target_neut_verts=mb["neut_verts"],
              idindex=mb["idindex"], camindex=mb["camindex"], running_avg_scale=True,
              gt_geo=mb["verts"], residuals_weight=0.0, deterministic=True,
              **{k: mb[k] for k in BATCH_MODEL_KEYS})
    driven = ds.get_neutral_conditioning(1)
    return (model, ds, torch.from_numpy(driven["neut_avgtex"][None]),
            torch.from_numpy(driven["neut_verts"][None]))


def frame(scene):
    model, ds, tex, verts = scene
    mb = Uploader("cpu").now(to_model_batch(none_collate([ds[0]])))
    return (decode(model, mb, mb["neut_avgtex"], mb["neut_verts"]),
            decode(model, mb, tex, verts))


def _spans(prof, names):
    return sorted((e for e in prof.events() if e.name in names),
                  key=lambda e: e.time_range.start)


def test_a_frame_records_its_spans(scene):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frame(scene)
    found = _spans(prof, FRAME_SPANS + CULL_STAGES)  # a dense cull: no stage span
    assert [e.name for e in found] == [
        "ava:collate", "ava:upload"] + ["ava:decode", "ava:raymarch", "ava:raymarch.cull"] * 2
    for decode_span, march, cull in (found[2:5], found[5:8]):
        assert decode_span.time_range.start <= march.time_range.start
        assert march.time_range.start <= cull.time_range.start
        assert cull.time_range.end <= march.time_range.end <= decode_span.time_range.end
    assert len({e.thread for e in found}) == 1


def test_no_profiler_no_record_function(scene, monkeypatch):
    model, ds, tex, verts = scene
    mb = Uploader("cpu").now(to_model_batch(none_collate([ds[0]])))
    image = decode(model, mb, tex, verts)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    assert not autograd_profiler._is_profiler_enabled
    again = frame(scene)[1]
    np.testing.assert_array_equal(again.numpy(), image.numpy())
    assert float(image.abs().sum()) > 0
    # the patch is the one the spans would take: under a profiler it refuses
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="ava:collate"):
            frame(scene)


def test_spans_nest_and_close():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("train_step"):
            with annotate("ava:decode"):
                torch.ones(4).sum()
            with pytest.raises(ValueError), annotate("ava:upload"):
                raise ValueError("a span closes on an exception")
    outer, inner, failed = _spans(prof, ("train_step", "ava:decode", "ava:upload"))
    assert (outer.name, inner.name, failed.name) == ("train_step", "ava:decode", "ava:upload")
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= failed.time_range.start <= failed.time_range.end
    assert failed.time_range.end <= outer.time_range.end
    with annotate("ava:decode"):  # after the profiler: nothing recorded, nothing raised
        pass


def _march_scene():
    """A small scene of 64 boxes culled in two stages: groups of 8, of which
    each tile keeps its earliest 3 (most tiles' slots are full, not all),
    and 12 candidates."""
    s = raymarch_scene(n=2, h=17, w=17, k3=4, bs=2, seed=5)
    t = {k: torch.from_numpy(np.array(v)) for k, v in s.items() if isinstance(v, np.ndarray)}
    args = (t["raypos"], t["raydir"], s["stepsize"], t["tminmax"], t["primpos"],
            rodrigues(t["primrvec"]), t["primscale"] * 10.0, t["template"])
    kw = dict(tile=8, max_hit=12, nbuf=16, cull_group_size=8, cull_max_groups=3,
              device="cpu")
    return args, kw


def test_the_two_stage_cull_opens_its_two_spans_inside_the_cull():
    args, kw = _march_scene()
    names = ("ava:raymarch", "ava:raymarch.cull") + CULL_STAGES
    for two_stage, want in ((True, names), (False, names[:2])):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            rc.mvp_raymarch_cuda(*args, two_stage_cull=two_stage, **kw)
        found = _spans(prof, names)
        assert [e.name for e in found] == list(want), two_stage
        for outer, inner in zip(found, found[1:3]):
            assert outer.time_range.start <= inner.time_range.start
            assert inner.time_range.end <= outer.time_range.end
        if two_stage:
            groups, members = found[2:]
            assert groups.time_range.end <= members.time_range.start
            assert members.time_range.end <= found[1].time_range.end
    rc.take_cull_counts()


def test_the_cull_counters_count_what_the_cull_returns(monkeypatch):
    args, kw = _march_scene()
    raypos, raydir, dt, tminmax, primpos, _, primscale, _ = args
    rc.take_cull_counts()
    kept = []
    smallest = rc._smallest
    monkeypatch.setattr(rc, "_smallest", lambda key, k: kept.append(smallest(key, k)) or kept[-1])
    want = dict.fromkeys(("tiles", "groups_full", "candidates_full", "candidates"), 0)
    with profile(activities=[ProfilerActivity.CPU]):
        for max_hit in (12, 40):
            kept.clear()
            out = rc.tile_and_cull(raypos, raydir, tminmax, primpos, primscale,
                                   torch.ones(primpos.shape[:2]), kw["tile"], max_hit, dt,
                                   cull_group_size=8, cull_max_groups=3, two_stage=True)
            valid, groups = out[4], torch.isfinite(kept[0][0])
            want["tiles"] += valid.shape[0]
            want["groups_full"] += int(groups.all(dim=1).sum())
            want["candidates_full"] += int(valid.all(dim=1).sum())
            want["candidates"] += int(valid.sum())
    got = rc.take_cull_counts()
    assert got == want
    assert 0 < want["groups_full"] < want["tiles"] and 0 < want["candidates_full"] < want["tiles"]
    assert rc.take_cull_counts() == dict.fromkeys(want, 0)


def test_no_profiler_no_cull_count_and_no_record_function(monkeypatch):
    args, kw = _march_scene()
    rc.take_cull_counts()
    image = rc.mvp_raymarch_cuda(*args, two_stage_cull=True, **kw)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    again = rc.mvp_raymarch_cuda(*args, two_stage_cull=True, **kw)
    np.testing.assert_array_equal(again.numpy(), image.numpy())
    assert float(image[..., 3].sum()) > 0
    assert dataclasses.astuple(rc.CULL_COUNTS) == (0, 0, 0, 0)
