# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
from ava256_tpu_torch.parallel.mesh import (
    COUNTS,
    all_gather,
    all_ranks,
    all_reduce_gradients,
    all_reduce_max_,
    all_reduce_mean,
    backend,
    barrier,
    batch_rows,
    destroy,
    init_from_env,
    is_initialized,
    rank,
    world_size,
)
from ava256_tpu_torch.parallel.render import render_rays_sharded

__all__ = ["COUNTS", "all_gather", "all_ranks", "all_reduce_gradients", "all_reduce_max_",
           "all_reduce_mean", "backend", "barrier", "batch_rows", "destroy", "init_from_env",
           "is_initialized", "rank", "world_size", "render_rays_sharded"]
