# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The flagship configuration's numbers, ``configs/config-synthetic-flagship.yaml``
as a dict: the training loop's built-in settings and the smoke test's, for
hosts without yaml. ``tests/test_torch_port_train.py`` holds it equal to the
yaml file."""

FLAGSHIP = dict(
    # data (synthetic capture)
    nident=4, ncams=10, nframes=32, height=512, width=334, texsize=1024, holdout_cameras=2,
    # model
    nprims=16384, primsize=8, volradius=256.0, colorcal=True, bgmodel=True,
    tile=16, max_hit=64,
    # training
    batch=4, maxiter=5000, optimizer="adam", lr=2.0e-4, gamma=1.4, lr_scheduler_iter=10000,
    clip=1.0, warmup_iters=100,
    losses=dict(irgbl1=1.0, vertl1=0.1, kldiv=1.0e-3, primvolsum=0.01),
    output_set=("irgbrec", "primscale"),
)
