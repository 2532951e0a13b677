"""Device-idle ms per frame while the host's innermost span is one of the
two-stage cull's spans (``ava:raymarch.cull.groups``,
``ava:raymarch.cull.members``). That idle leaves ``idle_raymarch_ms``, so
with this metric the idle readers of a two-stage cell add up to the tail's
idle time. None where the program opened neither span."""

from benchmark.harness import spans

CULL_STAGES = ("ava:raymarch.cull.groups", "ava:raymarch.cull.members")


def read(rec):
    if not any(name in CULL_STAGES for _, _, name in spans.program_spans(rec.get("events") or [])):
        return None
    return spans.idle_ms(rec, "render", CULL_STAGES)
