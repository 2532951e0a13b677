"""Valid march candidates per frame over the traced tail's two-stage culls
(both decodes of a frame): the program's cull counters
(``records["cull_counts"]`` of the ``render_counted`` loop) over the traced
frames."""

from benchmark.harness import trace


def read(rec):
    counts = rec.get("cull_counts") if rec.get("loop") == "render" else None
    n = len(trace.units(rec.get("events") or []))
    if not counts or not counts["tiles"] or not n:
        return None
    return counts["candidates"] / n
