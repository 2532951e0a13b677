"""Device ms per step of the march kernels, by symbol."""

from benchmark.harness import readers


def read(rec):
    return readers.kernel_ms(rec, "train", readers.MARCH_KERNELS)
