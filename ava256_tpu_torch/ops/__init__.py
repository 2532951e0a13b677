# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
from ava256_tpu_torch.ops.geomap import generate_geomap  # noqa: F401
from ava256_tpu_torch.ops.grid_sample import grid_sample_2d, resize_bilinear  # noqa: F401
from ava256_tpu_torch.ops.layers import (  # noqa: F401
    LEAKY_GAIN, Conv2d, Conv2dWN, ConvSeq, ConvTranspose2dWN, Linear, LinearWN, leaky_relu)
from ava256_tpu_torch.ops.math3d import (  # noqa: F401
    normalize, quaternion_to_matrix, rodrigues)
from ava256_tpu_torch.ops.raydirs import compute_raydirs  # noqa: F401
from ava256_tpu_torch.ops.raymarch_cuda import mvp_raymarch_cuda  # noqa: F401
from ava256_tpu_torch.ops.raymarch_ref import mvp_raymarch_reference  # noqa: F401
