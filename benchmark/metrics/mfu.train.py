"""Model FLOPs of the untraced window's steps (the reference model's count)
over its seconds and the chip's peak for the configuration's dtype, in %."""

from benchmark.harness import readers


def read(rec):
    return readers.mfu(rec, "train")
