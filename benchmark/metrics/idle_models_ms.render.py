"""Device-idle ms per frame while the host is inside ``ava:decode`` and
outside ``ava:raymarch``: the models' host side."""

from benchmark.harness import spans


def read(rec):
    return spans.idle_ms(rec, "render", spans.MODELS)
