# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
from ava256_tpu_torch.data.dataset import (  # noqa: F401
    CameraSplit, MissingDecoderError, MugsyCapture, MultiCaptureDataset, SingleCaptureDataset,
    get_framelist_neuttex_and_neutvert, last_n_camindices, none_collate, read_frame_list,
    train_csv_loader)
from ava256_tpu_torch.data.png import decode_png  # noqa: F401
from ava256_tpu_torch.data.loader import ShardedLoader, device_prefetch  # noqa: F401
from ava256_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticDataset, synthetic_uvdata, write_capture, write_topology_obj)
