"""The device's idle share of the untraced window, in %: its busy time a
step in the traced tail over the window's seconds a step."""

from benchmark.harness import readers


def read(rec):
    return readers.idle_share(rec, "train")
