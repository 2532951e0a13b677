# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Decoder assembler, as in ``ava256_tpu.models.decoders.assembler``: codes
-> a renderable Mixture of Volumetric Primitives (RGBA template boxes and
per-primitive position, rotation and scale).

1. Geometry decoder -> opacity boxes, predicted vertices, SRT residuals.
2. Denormalize the vertices (or take the ground-truth guide mesh).
3. Rasterize the guide mesh into a position map and place the K primitives
   at the centres of its stride x stride blocks.
4. Primitive scale: for 256 and 16384 primitives an EMA of 2 / neighbour
   distance (the ``adaptwarps`` buffer, updated in ``forward`` when
   ``running_avg_scale``), floored at nh / 12.8; otherwise a table constant.
5. TBN rotation frames from position-map differences inside each block.
6. Apply the SRT residuals, ramped by ``residuals_weight``.
7. RGB decoder -> colours; template = [relu(rgb * 25 + 100), relu(alpha)].
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ava256_tpu_torch.models.decoders.geometry import GeometryDecoder
from ava256_tpu_torch.models.decoders.rgb import RGBDecoder
from ava256_tpu_torch.ops.geomap import generate_geomap
from ava256_tpu_torch.ops.layers import remat
from ava256_tpu_torch.ops.math3d import rodrigues

_PRIMSCALE_TABLE = {1: 2.0, 8: 4.0, 64: 8.0, 256: 12.0, 512: 16.0, 4096: 32.0,
                    16384: 48.0, 32768: 64.0, 262144: 128.0}
_ADAPTIVE_NPRIMS = (256, 16384)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)), min=1e-8)


class DecoderAssembler(nn.Module):
    def __init__(self, vt: np.ndarray, vi: np.ndarray, vti: np.ndarray, idxim: np.ndarray,
                 barim: np.ndarray, vertmean: np.ndarray, vertstd: float, volradius: float,
                 nprims: int = 128 * 128, primsize: Tuple[int, int, int] = (8, 8, 8)):
        super().__init__()
        nh = int(np.sqrt(nprims))
        if nh * nh != nprims:
            raise ValueError(f"nprims must be a perfect square, got {nprims}")
        posmap_res = int(np.asarray(idxim).shape[-1])
        if posmap_res % nh != 0:
            raise ValueError(f"nprims grid {nh} must divide the {posmap_res} position map")
        self.nh, self.nprims, self.stride = nh, nprims, posmap_res // nh
        self.vertstd, self.volradius = float(vertstd), float(volradius)
        imsize = nh * primsize[1]
        self.rgbdec = RGBDecoder(imsize=imsize, nboxes=nprims, boxsize=primsize[0], outch=3,
                                 viewcond=True)
        self.geodec = GeometryDecoder(
            uv=vt, tri=vi, uvtri=vti, nvtx=int(np.asarray(vertmean).shape[-2]),
            motion_size={256: 16, 16384: 128}.get(nprims, nh),
            geo_size=256 if imsize > 256 else imsize // 2, imsize=imsize, nboxes=nprims,
            boxsize=primsize[0])
        self.register_buffer("idxim", torch.as_tensor(np.asarray(idxim), dtype=torch.int64),
                             persistent=False)
        self.register_buffer("barim", torch.as_tensor(np.asarray(barim), dtype=torch.float32),
                             persistent=False)
        self.register_buffer("vertmean", torch.as_tensor(np.asarray(vertmean),
                                                         dtype=torch.float32), persistent=False)
        self.register_buffer("adaptwarps", torch.zeros(nprims))

    def forward(self, id_cond: Dict[str, Any], expr_encoding: torch.Tensor,
                viewpos: torch.Tensor, running_avg_scale: bool = False,
                gt_geo: Optional[torch.Tensor] = None,
                residuals_weight: float = 1.0) -> Dict[str, torch.Tensor]:
        """id_cond: z_geo/z_tex [N, 4, 4, 16] and NHWC b_geo/b_tex pyramids;
        expr_encoding [N, 4, 4, 16]; viewpos [N, 3] model-relative camera.
        Returns verts [N, V, 3], template [N, K, bs, bs, bs, 4], primpos
        [N, K, 3], primrot [N, K, 3, 3], primscale [N, K, 3]."""
        n = expr_encoding.shape[0]
        K, s, nh = self.nprims, self.stride, self.nh
        c = s // 2

        # the decoder towers are recomputed in the backward pass; the
        # adaptwarps update below is outside them and runs once
        opacity, geo, pos_resid, rvec_resid, scale_resid = remat(
            self.geodec, expr_encoding, id_cond["z_geo"], id_cond["b_geo"])
        geo = geo * self.vertstd + self.vertmean
        predicted_geo = geo
        if gt_geo is not None:
            geo = gt_geo * self.vertstd + self.vertmean

        postex = generate_geomap(geo, self.idxim, self.barim) / self.volradius
        primpos = postex[:, c::s, c::s, :].reshape(n, K, 3)

        if K in _ADAPTIVE_NPRIMS:
            if running_avg_scale:
                cx = postex[:, c::s, c + s:: s, :] - postex[:, c::s, c:-s:s, :]
                cx = torch.cat([cx, cx[:, :, -1:, :]], dim=2)
                cy = postex[:, c + s:: s, c::s, :] - postex[:, c:-s:s, c::s, :]
                cy = torch.cat([cy, cy[:, -1:, :, :]], dim=1)
                centsize = torch.maximum(torch.sqrt(torch.sum(cx * cx, dim=-1)),
                                         torch.sqrt(torch.sum(cy * cy, dim=-1)))
                centsize = torch.amax(centsize, dim=0).reshape(K)
                # the floor keeps UV-seam texels (neighbours across the atlas)
                # from making primitives as large as the volume
                warps_vec = torch.clamp((2.0 / centsize).detach(), min=nh / 12.8)
                old = self.adaptwarps
                new = warps_vec if bool(torch.amax(old) == 0.0) else old * 0.9 + 0.1 * warps_vec
                self.adaptwarps.copy_(new)
            aw = self.adaptwarps
            primscale = (aw * 0.8)[None, :, None].expand(n, K, 3)
        else:
            const = _PRIMSCALE_TABLE.get(K, 0.4 * nh)
            primscale = torch.full((n, K, 3), const, dtype=postex.dtype, device=postex.device)

        # TBN frames from forward differences inside each position-map block
        blocks = postex.reshape(n, nh, s, nh, s, 3)
        ctr = blocks[:, :, c, :, c, :]
        tangent = _unit(blocks[:, :, c, :, c + 1, :] - ctr)
        vcenterdv = blocks[:, :, c + 1, :, c, :] - ctr
        normal = _unit(torch.cross(tangent, vcenterdv, dim=-1))
        bitangent = _unit(torch.cross(normal, tangent, dim=-1))
        primrot = torch.stack([tangent, bitangent, normal], dim=-1).reshape(n, K, 3, 3)

        rw = min(max(float(residuals_weight), 0.0), 1.0)
        primpos = primpos + pos_resid * rw
        primrot = torch.einsum("nkij,nkjl->nkil", primrot, rodrigues(rvec_resid * rw))
        primscale = primscale * (scale_resid * rw + (1.0 - rw))

        viewdirs = viewpos / torch.sqrt(torch.sum(viewpos**2, dim=1, keepdim=True))
        primrgb = remat(self.rgbdec, expr_encoding, id_cond["z_tex"], id_cond["b_tex"],
                        viewdirs)
        template = torch.cat([torch.relu(primrgb * 25.0 + 100.0), torch.relu(opacity)], dim=-1)
        return {"verts": predicted_geo, "template": template, "primpos": primpos,
                "primrot": primrot, "primscale": primscale}
