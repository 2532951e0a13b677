"""The ``render`` loop with the program's cull counters: ``render.run``,
then the two-stage culls' counts of its traced tail
(``ava256_tpu_torch.ops.raymarch_cuda`` ``take_cull_counts``, counted only
while the profiler records) put into ``records["cull_counts"]``. Its
``readings`` are the render loop's. A program without the counters leaves
the records without them, and their readers read nothing."""

from __future__ import annotations

from ava256_tpu_torch.ops import raymarch_cuda

from benchmark.harness import spec

readings = spec.loop("render").readings


def run(r) -> dict:
    take = getattr(raymarch_cuda, "take_cull_counts", None)
    if take is not None:
        take()  # what an earlier run of this process left
    res = spec.loop("render").run(r)
    if take is not None and r.trace:
        res["records"]["cull_counts"] = take()
    return res
