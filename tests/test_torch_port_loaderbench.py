# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""``python -m ava256_tpu_torch.loaderbench``, the port of the JAX package's
``scripts/loaderbench.py``, at a small size on the CPU: one JSON line with the
JAX script's fields, items/s for each worker count, and AVIF refused (the
card host has no Pillow). Its full size (4096x2668 PNGs) runs on the card
host: ``chip_smoke.py`` ``[loaderbench]``."""

import json

import pytest

from ava256_tpu_torch import loaderbench

from tests import _torch_port_threads  # noqa: F401

# the fields scripts/loaderbench.py prints, workers 1 and 2
FIELDS = {"source_px", "codec", "downsample", "workers", "single_thread_item_s",
          "items_per_s_w1", "items_per_s_w2", "flagship_need_items_per_s", "fixture_build_s"}


def test_prints_the_jax_scripts_fields(capsys):
    assert loaderbench.main(["--frames", "2", "--items", "4", "--small", "--workers", "1,2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == FIELDS
    assert (line["source_px"], line["codec"], line["workers"]) == ("512x334", "png", "threads")
    assert line["items_per_s_w1"] > 0 and line["items_per_s_w2"] > 0
    assert line["single_thread_item_s"] > 0


def test_avif_is_refused():
    with pytest.raises(SystemExit):
        loaderbench.main(["--codec", "avif"])
