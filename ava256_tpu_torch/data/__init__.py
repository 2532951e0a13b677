# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
from ava256_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticDataset, none_collate, synthetic_uvdata)
