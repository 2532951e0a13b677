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
- spans nest, and ``train_step``'s span goes through the same helper.
"""

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from ava256_tpu_torch import bench
from ava256_tpu_torch.data.dataset import none_collate
from ava256_tpu_torch.data.loader import Uploader
from ava256_tpu_torch.render import BATCH_MODEL_KEYS, decode
from ava256_tpu_torch.train.loop import to_model_batch
from ava256_tpu_torch.train.profiling import annotate

from tests import _torch_port_threads  # noqa: F401

TINY = dict(batch=1, height=8, width=8, nprims=256, texsize=64, primsize=16,
            raymarch_options={"tile": 8, "max_hit": 4, "nbuf": 16, "dt": 16.0})
FRAME_SPANS = ("ava:collate", "ava:upload", "ava:decode", "ava:raymarch", "ava:raymarch.cull")


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
    found = _spans(prof, FRAME_SPANS)
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
