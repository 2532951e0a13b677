"""The readers of the program's spans against hand counts on a hand-written
Chrome trace of two frames: a gap is charged to the innermost span live
over each part of it, the four idle metrics add up to the tail's idle
time, a kernel is charged to the span that holds its launch, and spans on
another thread are not read."""

import pytest

from benchmark.harness import spans, trace
from benchmark.harness import spec as S


def _ev(name, cat, ts, dur, tid=1, **args):
    return dict(ph="X", name=name, cat=cat, pid=1, tid=tid, ts=float(ts), dur=float(dur),
                args=args)


SPANS = [
    # frame 1: collate, upload, then a decode holding the march and its cull
    _ev("ava:collate", "user_annotation", 0, 10),
    _ev("ava:upload", "user_annotation", 10, 10),
    _ev("ava:decode", "user_annotation", 25, 35),
    _ev("ava:raymarch", "user_annotation", 40, 15),
    _ev("ava:raymarch.cull", "user_annotation", 42, 8),
    # frame 2: a decode alone
    _ev("ava:decode", "user_annotation", 110, 80),
    # another thread's span, over both frames: not read
    _ev("ava:upload", "user_annotation", 0, 200, tid=2),
]
EVENTS = SPANS + [
    _ev(trace.UNIT, "user_annotation", 0, 100),
    _ev(trace.UNIT, "user_annotation", 100, 100),
    _ev("module:decoder", "user_annotation", 26, 30),
    _ev("cudaLaunchKernel", "cuda_runtime", 30, 1, correlation=2),
    _ev("cudaLaunchKernel", "cuda_runtime", 43, 1, correlation=1),
    _ev("cudaLaunchKernel", "cuda_runtime", 53, 1, correlation=3),
    _ev("cudaLaunchKernel", "cuda_runtime", 115, 1, correlation=4),
    _ev("conv_kernel", "kernel", 32, 6, tid=7, correlation=2),
    _ev("topk_kernel", "kernel", 45, 7, tid=7, correlation=1),
    _ev("mvp_march_fwd_kernel", "kernel", 56, 2, tid=7, correlation=3),
    _ev("conv_kernel", "kernel", 120, 30, tid=7, correlation=4),
]
# gaps [0, 32], [38, 45], [52, 56], [58, 120], [150, 200]: 155 us idle of 200
IDLE_US = {"ava:collate": 10, "ava:upload": 10, "ava:decode": 7 + 2 + 1 + 2 + 10 + 40,
           "ava:raymarch": 2 + 3, "ava:raymarch.cull": 3, spans.UNSPANNED: 5 + 50 + 10}
READS = {"input_ms.render": 20e-3 / 2, "cull_ms.render": 7e-3 / 2,
         "idle_input_ms.render": 20e-3 / 2, "idle_models_ms.render": 62e-3 / 2,
         "idle_raymarch_ms.render": 8e-3 / 2, "idle_unspanned_ms.render": 65e-3 / 2}
IDLE = [m for m in READS if m.startswith("idle_")]
REC = {"loop": "render", "gpu": True, "events": EVENTS, "steps": 8, "window_s": 1.0}


def test_a_gap_is_cut_among_the_innermost_spans():
    found = spans.program_spans(EVENTS)
    assert [s[2] for s in found] == [e["name"] for e in SPANS[:-1]]
    # [38, 45] lies in the decode, its march and the cull: 2, 2 and 3 us
    assert spans.idle_us(EVENTS, found) == pytest.approx(IDLE_US)
    pieces = spans.innermost(found, 0.0, 200.0)
    for piece in ((40, 42, "ava:raymarch"), (42, 50, "ava:raymarch.cull"),
                  (50, 55, "ava:raymarch"), (55, 60, "ava:decode"), (60, 110, spans.UNSPANNED)):
        assert piece in pieces


def test_the_idle_metrics_add_up_to_the_tails_idle_time():
    busy, span, _ = trace.busy_and_gaps(EVENTS)
    assert (busy, span) == (45, 200)
    got = {m: S.reader(m)(REC) for m in IDLE}
    assert got == pytest.approx({m: READS[m] for m in IDLE})
    assert sum(got.values()) == pytest.approx((span - busy) / 1e3 / 2)


def test_a_kernel_is_charged_to_the_span_of_its_launch():
    # the cull's kernel (launched at 43) runs after the cull's span has closed;
    # a span holds the launches of the spans inside it
    assert spans.launched_ms(REC, "render", spans.CULL) == pytest.approx(7e-3 / 2)
    assert spans.launched_ms(REC, "render", ("ava:raymarch",)) == pytest.approx(9e-3 / 2)
    assert spans.launched_ms(REC, "render", spans.MODELS) == pytest.approx(45e-3 / 2)
    assert spans.launched_ms(REC, "render", ("ava:collate",)) == 0.0


def test_the_metrics_read_the_spans():
    assert {m: S.reader(m)(REC) for m in READS} == pytest.approx(READS)
    assert {m["name"] for m in S.load_spec()["per_layer"]
            if m["source"] == "program_span"} == set(READS)


def test_nothing_to_read_is_none():
    parent = [e for e in EVENTS if not e["name"].startswith(spans.PREFIX)]
    for rec in (dict(REC, gpu=False), dict(REC, loop="train"), dict(REC, events=parent),
                dict(REC, events=[])):
        assert {m: S.reader(m)(rec) for m in READS} == dict.fromkeys(READS)
