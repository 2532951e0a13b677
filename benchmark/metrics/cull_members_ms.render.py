"""Device ms per frame of the work launched inside the program's
``ava:raymarch.cull.members`` span: the kept groups' members gathered,
tested and cut to the earliest ``max_hit``."""

from benchmark.harness import spans


def read(rec):
    return spans.launched_ms(rec, "render", ("ava:raymarch.cull.members",))
