# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
from ava256_tpu_torch.models.autoencoder import Autoencoder  # noqa: F401
from ava256_tpu_torch.models.bg import BackgroundModelSimple  # noqa: F401
from ava256_tpu_torch.models.bottleneck import VAEBottleneck, kl_loss_stable  # noqa: F401
from ava256_tpu_torch.models.colorcal import Colorcal  # noqa: F401
from ava256_tpu_torch.models.decoders.assembler import DecoderAssembler  # noqa: F401
from ava256_tpu_torch.models.decoders.geometry import GeometryDecoder  # noqa: F401
from ava256_tpu_torch.models.decoders.rgb import RGBDecoder  # noqa: F401
from ava256_tpu_torch.models.encoders.expression import ExpressionEncoder  # noqa: F401
from ava256_tpu_torch.models.encoders.identity import IdentityEncoder  # noqa: F401
