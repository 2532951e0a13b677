"""Device ms per frame launched by the raymarcher (cull, affines, march
kernels, untile), backward included."""

from benchmark.harness import readers


def read(rec):
    return readers.module_ms(rec, "render", ("raymarcher",))
