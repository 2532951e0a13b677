"""Device ms per frame of the work launched inside the program's
``ava:raymarch.cull.groups`` span: the two-stage cull's Morton order, group
spheres, group cone test and the earliest groups."""

from benchmark.harness import spans


def read(rec):
    return spans.launched_ms(rec, "render", ("ava:raymarch.cull.groups",))
