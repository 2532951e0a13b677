"""The device's idle share of the untraced window, in %: its busy time a
frame in the traced tail over the window's seconds a frame."""

from benchmark.harness import readers


def read(rec):
    return readers.idle_share(rec, "render")
