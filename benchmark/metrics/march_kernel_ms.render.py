"""Device ms per frame of the march kernels, by symbol."""

from benchmark.harness import readers


def read(rec):
    return readers.kernel_ms(rec, "render", readers.MARCH_KERNELS)
