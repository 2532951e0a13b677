"""Host ms per step waiting on the prefetched loader (next() of
device_prefetch), over the untraced window."""

from benchmark.harness import readers


def read(rec):
    return readers.mean_ms(rec, "loader_wait_s", "train")
