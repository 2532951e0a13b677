# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""ava256_tpu_torch — the PyTorch/CUDA port of ava256_tpu for NVIDIA Hopper.

The JAX package ``ava256_tpu`` stays the reference; this package mirrors its
layout and never imports it:

- ``ops``     — weight-normalized layers, grid sampling, geometry maps, ray
  generation, the PyTorch raymarch oracle and the CUDA raymarcher
  (``csrc/mvp_march_fwd.cu``, built at first use);
- ``models``  — encoders, VAE bottleneck, decoders, assembler, color
  calibration, background model, full autoencoder;
- ``data``    — the synthetic dataset and topology;
- ``factory`` / ``convert`` / ``render`` — model construction, flax weight
  conversion and frame decoding.
"""

__version__ = "0.1.0"
