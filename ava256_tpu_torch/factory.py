# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Model factory, as in ``ava256_tpu.factory``: wires the full autoencoder
from topology assets and dataset normalization statistics (volradius 256,
nprims 128^2, primsize 8^3, VAE 64 -> 16, identity warp 128)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ava256_tpu_torch.models.autoencoder import Autoencoder
from ava256_tpu_torch.models.bg import BackgroundModelSimple
from ava256_tpu_torch.models.bottleneck import VAEBottleneck
from ava256_tpu_torch.models.colorcal import Colorcal
from ava256_tpu_torch.models.decoders.assembler import DecoderAssembler
from ava256_tpu_torch.models.encoders.expression import ExpressionEncoder
from ava256_tpu_torch.models.encoders.identity import IdentityEncoder
from ava256_tpu_torch.models.raymarcher import Raymarcher
from ava256_tpu_torch.ops.raymarch_cuda import resolve_device


def get_autoencoder(
    uvdata: Dict[str, np.ndarray],
    vertmean: np.ndarray,
    vertstd: float,
    ncams: int,
    nident: int,
    volradius: float = 256.0,
    nprims: int = 128 * 128,
    primsize: Tuple[int, int, int] = (8, 8, 8),
    colorcal: bool = True,
    bgmodel: bool = True,
    raymarch_backend: str = "cuda",
    raymarch_options: Optional[Dict[str, Any]] = None,
    device="cuda",
    seed: int = 0,
    dtype: Optional[torch.dtype] = None,
) -> Autoencoder:
    """Build the autoencoder on ``device`` (CUDA unless the caller asks for
    the CPU), its weights drawn from a generator seeded with ``seed``.
    ``dtype`` (None or ``torch.bfloat16``) is the activations' compute dtype
    in the encoders, the bottleneck, the decoders and the background model,
    as the JAX factory's; parameters and the march stay float32, and so does
    the colour calibration, which runs on the march's output (JAX's takes
    the dtype and does not use it).

    uvdata: uv_idx / uv_bary [3, M, M], uv_coord, uv_tri, tri (see
    ``data.synthetic.synthetic_uvdata``). vertmean [V, 3], vertstd scalar.
    fp32 stays fp32 on the card: TF32 is switched off for cuDNN convolutions
    and cuBLAS matmuls, which would otherwise round conv inputs to 10 bits.

    Every path that builds the model runs deterministically, as JAX does on
    the TPU, with no switch to turn it off: ``use_deterministic_algorithms``
    in its raising mode (cuDNN takes deterministic algorithms, the gathers'
    backwards their sorting paths, and an operation with no deterministic
    form raises), cuDNN's autotuner off (it could pick another algorithm in
    another process), and cuBLAS's workspace fixed by
    ``CUBLAS_WORKSPACE_CONFIG``, which the package sets when it is imported.
    PyTorch's fill of uninitialized memory, a debugging aid that launches a
    fill for every allocation, stays off: every operation writes its whole
    output. The hand-written kernels' sums are order-free by design.
    """
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    rm_opts = dict(raymarch_options or {})
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = Autoencoder(
            identity_encoder=IdentityEncoder(uvdata["uv_idx"], uvdata["uv_bary"], wsize=128,
                                             dtype=dtype),
            expression_encoder=ExpressionEncoder(uvdata["uv_idx"], uvdata["uv_bary"],
                                                 dtype=dtype),
            bottleneck=VAEBottleneck(64, 16, dtype=dtype),
            decoder_assembler=DecoderAssembler(
                vt=np.asarray(uvdata["uv_coord"], dtype=np.float32),
                vi=np.asarray(uvdata["tri"], dtype=np.int32),
                vti=np.asarray(uvdata["uv_tri"], dtype=np.int32),
                idxim=uvdata["uv_idx"], barim=uvdata["uv_bary"],
                vertmean=np.asarray(vertmean, dtype=np.float32), vertstd=float(vertstd),
                volradius=volradius, nprims=nprims, primsize=primsize, dtype=dtype),
            raymarcher=Raymarcher(volradius, dt=rm_opts.pop("dt", 1.0),
                                  backend=raymarch_backend, **rm_opts),
            colorcal=Colorcal(ncams, nident) if colorcal else None,
            bgmodel=BackgroundModelSimple(ncams, nident, dtype=dtype) if bgmodel else None,
        )
    return model.to(device)
