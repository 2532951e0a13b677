"""Device-idle ms per frame while the host is inside ``ava:raymarch``: the
raymarch op's host side, its cull included."""

from benchmark.harness import spans


def read(rec):
    return spans.idle_ms(rec, "render", spans.RAYMARCH)
