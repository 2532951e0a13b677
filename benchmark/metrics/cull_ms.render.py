"""Device ms per frame of the work launched inside the program's
``ava:raymarch.cull`` span (``tile_and_cull``), launches matched by their
correlation."""

from benchmark.harness import spans


def read(rec):
    return spans.launched_ms(rec, "render", spans.CULL)
