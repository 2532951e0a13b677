# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Small 3D math ops, as in ``ava256_tpu.ops.math3d``: Rodrigues vectors to
matrices (with the 1e-5 epsilon under the square root that keeps the zero
vector differentiable; in bfloat16 it is rounded to bfloat16, as JAX
takes it), quaternions to matrices and vector normalization."""

from __future__ import annotations

import torch

from ava256_tpu_torch.ops.layers import weak


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    n = torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True))
    if eps:
        n = torch.clamp(n, min=eps)
    return v / n


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation vectors [..., 3] -> rotation matrices [..., 3, 3]."""
    theta = torch.sqrt(weak(1e-5, rvec) + torch.sum(rvec**2, dim=-1))
    r = rvec / theta[..., None]
    costh = torch.cos(theta)
    sinth = torch.sin(theta)
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    one_m_c = 1.0 - costh
    mat = torch.stack(
        [
            x * x + (1.0 - x * x) * costh,
            x * y * one_m_c - z * sinth,
            x * z * one_m_c + y * sinth,
            x * y * one_m_c + z * sinth,
            y * y + (1.0 - y * y) * costh,
            y * z * one_m_c - x * sinth,
            x * z * one_m_c - y * sinth,
            y * z * one_m_c + x * sinth,
            z * z + (1.0 - z * z) * costh,
        ],
        dim=-1,
    )
    return mat.reshape(rvec.shape[:-1] + (3, 3))


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternions [..., 4] (x, y, z, w) -> rotation matrices [..., 3, 3]."""
    theta = torch.sqrt(1e-5 + torch.sum(q**2, dim=-1))
    q = q / theta[..., None]
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    mat = torch.stack(
        [
            1.0 - 2.0 * y * y - 2.0 * z * z,
            2.0 * (x * y - z * w),
            2.0 * (x * z + y * w),
            2.0 * (x * y + z * w),
            1.0 - 2.0 * x * x - 2.0 * z * z,
            2.0 * (y * z - x * w),
            2.0 * (x * z - y * w),
            2.0 * (x * w + y * z),
            1.0 - 2.0 * x * x - 2.0 * y * y,
        ],
        dim=-1,
    )
    return mat.reshape(q.shape[:-1] + (3, 3))
