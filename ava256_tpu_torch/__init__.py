# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""ava256_tpu_torch — the PyTorch/CUDA port of ava256_tpu for NVIDIA Hopper.

The JAX package ``ava256_tpu`` stays the reference; this package mirrors its
layout and never imports it:

- ``ops``     — weight-normalized layers, grid sampling, geometry maps, ray
  generation, the PyTorch raymarch oracle and the differentiable CUDA
  raymarcher (``csrc/mvp_march_fwd.cu``, ``csrc/mvp_march_bwd.cu``, built at
  first use);
- ``models``  — encoders, VAE bottleneck, decoders, assembler, color
  calibration, background model, full autoencoder;
- ``data``    — the synthetic dataset and topology, the camera hold-out,
  the sharded loader and device prefetch, device-resident conditioning
  tables;
- ``geometry`` — the topology ``.obj`` and its UV barycentric maps;
- ``train``   — losses, optimizer and checkpoints, the train step, the loop,
  image metrics, step timing and traces;
- ``parallel`` — data parallelism over ``torch.distributed`` (one process
  per device under ``torchrun``) and the ray-sharded render;
- ``cli``     — the entry points users run
  (``python -m ava256_tpu_torch.cli.{train,eval,render,generate_id_cond}``);
- ``config`` / ``utils`` — YAML configs with dotted overrides, PNG strips
  and logging;
- ``factory`` / ``convert`` / ``render`` / ``flagship`` — model construction,
  flax weight and train-state conversion, frame decoding, the flagship
  configuration's numbers.
"""

import os

# cuBLAS gives the same bits on every run only with a fixed workspace, and
# reads this when its first handle is made: set before any cuBLAS call (and
# inherited by the processes the package starts), a value the user set kept.
# factory.get_autoencoder asks PyTorch for deterministic algorithms.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

__version__ = "0.1.0"
