"""The grid-sample kernels' share of their roofline per step: the calls' least
bytes (each input read once, each output written once) at 3.35 TB/s over the
kernels' device time, in %."""

from benchmark.harness import readers


def read(rec):
    return readers.grid_sample_roofline(rec, "train")
