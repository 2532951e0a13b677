# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
from ava256_tpu_torch.geometry.krt import camera_params, load_camera_calibration  # noqa: F401
from ava256_tpu_torch.geometry.obj import load_obj  # noqa: F401
from ava256_tpu_torch.geometry.ply import parse_ply_vertices  # noqa: F401
from ava256_tpu_torch.geometry.uv import (  # noqa: F401
    closest_point_barycentrics_2d, create_uv_baridx, make_closest_uv_barys)
