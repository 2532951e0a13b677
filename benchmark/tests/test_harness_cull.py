"""The two-stage cull's readers (``prims262k.render``): against hand counts
on a hand-written Chrome trace of two frames, a kernel is charged to the
cull stage whose span holds its launch, and the cell's five idle readers
add up to the tail's idle time; the counters' readers read the loop's
records, and nothing where a program has no counters; a CPU rehearsal of
the cell through the harness is correct and reports the counters."""

import pytest

from benchmark.harness import spans, trace
from benchmark.harness import spec as S
from benchmark.tests.test_harness_rehearsal import _run, isolated  # noqa: F401


def _ev(name, cat, ts, dur, tid=1, **args):
    return dict(ph="X", name=name, cat=cat, pid=1, tid=tid, ts=float(ts), dur=float(dur),
                args=args)


EVENTS = [
    _ev(trace.UNIT, "user_annotation", 0, 100),
    _ev(trace.UNIT, "user_annotation", 100, 100),
    # frame 1: an upload, then a decode whose march culls in two stages
    _ev("ava:upload", "user_annotation", 0, 10),
    _ev("ava:decode", "user_annotation", 20, 70),
    _ev("ava:raymarch", "user_annotation", 40, 40),
    _ev("ava:raymarch.cull", "user_annotation", 42, 28),
    _ev("ava:raymarch.cull.groups", "user_annotation", 44, 10),
    _ev("ava:raymarch.cull.members", "user_annotation", 56, 10),
    # frame 2: a decode alone
    _ev("ava:decode", "user_annotation", 110, 80),
    # launches: a conv, the groups' sort, the members' sort, a count, the march, a conv
    _ev("cudaLaunchKernel", "cuda_runtime", 30, 1, correlation=1),
    _ev("cudaLaunchKernel", "cuda_runtime", 45, 1, correlation=2),
    _ev("cudaLaunchKernel", "cuda_runtime", 57, 1, correlation=3),
    _ev("cudaLaunchKernel", "cuda_runtime", 68, 1, correlation=4),
    _ev("cudaLaunchKernel", "cuda_runtime", 75, 1, correlation=5),
    _ev("cudaLaunchKernel", "cuda_runtime", 115, 1, correlation=6),
    _ev("conv_kernel", "kernel", 32, 8, tid=7, correlation=1),
    _ev("radix_sort", "kernel", 48, 4, tid=7, correlation=2),
    _ev("segmented_sort", "kernel", 58, 3, tid=7, correlation=3),
    _ev("reduce_kernel", "kernel", 69, 1, tid=7, correlation=4),
    _ev("mvp_march_fwd_kernel", "kernel", 76, 4, tid=7, correlation=5),
    _ev("conv_kernel", "kernel", 120, 30, tid=7, correlation=6),
]
# busy 50 us of 200; idle by innermost span: upload 10, unspanned 40, decode 72,
# raymarch 8, cull 7, groups 6, members 7
IDLE_READS = {"idle_input_ms.render": 10e-3 / 2, "idle_models_ms.render": 72e-3 / 2,
              "idle_raymarch_ms.render": 15e-3 / 2, "idle_cull_ms.render": 13e-3 / 2,
              "idle_unspanned_ms.render": 40e-3 / 2}
LAUNCH_READS = {"cull_ms.render": 8e-3 / 2, "cull_groups_ms.render": 4e-3 / 2,
                "cull_members_ms.render": 3e-3 / 2}
REC = {"loop": "render", "gpu": True, "events": EVENTS, "steps": 8, "window_s": 1.0}
COUNTS = {"tiles": 2688, "groups_full": 672, "candidates_full": 600, "candidates": 90000}
COUNTERS = ("cull_groups_full.render", "march_candidates.render")
CELL = "prims262k.render"


def test_the_cells_idle_readers_add_up_to_the_tails_idle_time():
    busy, span, _ = trace.busy_and_gaps(EVENTS)
    assert (busy, span) == (50, 200)
    idle = [m["name"] for m in S.metrics_of(S.load_spec(), S.cell(S.load_spec(), CELL),
                                            "per_layer") if m["name"].startswith("idle_")
            and m["name"] != "idle_share.render"]
    assert sorted(idle) == sorted(IDLE_READS)
    got = {m: S.reader(m)(REC) for m in idle}
    assert got == pytest.approx(IDLE_READS)
    assert sum(got.values()) == pytest.approx((span - busy) / 1e3 / 2)


def test_a_kernel_is_charged_to_the_cull_stage_of_its_launch():
    assert {m: S.reader(m)(REC) for m in LAUNCH_READS} == pytest.approx(LAUNCH_READS)


def test_the_counters_readers():
    rec = dict(REC, cull_counts=COUNTS)
    assert S.reader("cull_groups_full.render")(rec) == pytest.approx(25.0)
    assert S.reader("march_candidates.render")(rec) == pytest.approx(45000.0)
    for bad in (REC, dict(rec, loop="train"), dict(rec, cull_counts=dict(COUNTS, tiles=0))):
        assert {m: S.reader(m)(bad) for m in COUNTERS} == dict.fromkeys(COUNTERS)


def test_a_program_without_the_cull_stages_reads_nothing_there():
    parent = [e for e in EVENTS if not e["name"].startswith("ava:raymarch.cull.")]
    rec = dict(REC, events=parent)
    stages = ("idle_cull_ms.render", "cull_groups_ms.render", "cull_members_ms.render")
    assert {m: S.reader(m)(rec) for m in stages} == dict.fromkeys(stages)
    assert S.reader("idle_raymarch_ms.render")(rec) == pytest.approx(28e-3 / 2)


def test_the_cell_rehearses_correct_with_its_counters(isolated, capsys):  # noqa: F811
    rc, line = _run(capsys, ["--workload", CELL, "--seed", "2147490123", "--seconds", "1",
                             "--trace", "1", "--device", "cpu"])
    assert rc == 0 and line["correct"] is True
    assert line["checks"]["image_gap"]["value"] <= line["checks"]["image_gap"]["limit"]
    assert line["metrics"]["march_candidates.render"]["value"] > 0
    assert 0 <= line["metrics"]["cull_groups_full.render"]["value"] <= 100
