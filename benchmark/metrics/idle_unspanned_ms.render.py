"""Device-idle ms per frame while the host is in no ``ava:`` span: the
benchmark's own code and program code without a span."""

from benchmark.harness import spans


def read(rec):
    return spans.idle_ms(rec, "render", (spans.UNSPANNED,))
