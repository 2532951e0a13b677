"""Device-idle ms per frame while the host is inside ``ava:collate`` or
``ava:upload``."""

from benchmark.harness import spans


def read(rec):
    return spans.idle_ms(rec, "render", spans.INPUT)
