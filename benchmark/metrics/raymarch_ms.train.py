"""Device ms per step launched by the raymarcher (cull, affines, march kernels,
untile), backward included."""

from benchmark.harness import readers


def read(rec):
    return readers.module_ms(rec, "train", ("raymarcher",))
