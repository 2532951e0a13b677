"""Device ms per step between the step's backward and optimizer marks (scrub,
clip, Adam), over the untraced window."""

from benchmark.harness import readers


def read(rec):
    return readers.mean_ms(rec, "optimizer_s", "train")
