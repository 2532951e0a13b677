# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The capture demos, the port's counterparts of ``demos/`` (the reference's
``Data_Visualization_Demo.ipynb`` as scripts), without matplotlib or Pillow:

    python -m ava256_tpu_torch.demos.walkthrough --capture-dir DIR
    python -m ava256_tpu_torch.demos.keypoints --capture-dir DIR --frame 1
    python -m ava256_tpu_torch.demos.mesh --capture-dir DIR
    python -m ava256_tpu_torch.demos.segmentation --capture-dir DIR --frames 8

Each takes the reference demo's flags and defaults, reads the same data out
of a capture (``DIR`` is a capture's ``decoder`` directory in the ava-256
release layout) and writes one PNG drawn in numpy (``demos.draw``); the
titles the reference draws go to stdout, one line per panel. They run no
model and no kernel, so they take no ``--device``.
"""
