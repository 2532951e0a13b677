"""Host ms per frame inside the program's ``ava:collate`` and ``ava:upload``
spans (``none_collate``, ``Uploader`` and ``Upload.ready``)."""

from benchmark.harness import spans


def read(rec):
    return spans.host_ms(rec, "render", spans.INPUT)
