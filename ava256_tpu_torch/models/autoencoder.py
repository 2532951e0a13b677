# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Full volumetric autoencoder, as in ``ava256_tpu.models.autoencoder``:
identity-encode (or cached id_cond) -> expression-encode -> VAE bottleneck
-> decode (assemble primitives -> raymarch -> color calibration ->
background). Images are NHWC at the interface.

The modules' compute dtype (``factory.get_autoencoder(dtype=...)``) leaves
the march in float32, as in JAX: the decoders hand it float32 primitives and
template, and the rendered image is float32.
"""

from __future__ import annotations

from typing import Any, Dict, FrozenSet, Optional, Tuple

import torch
from torch import nn

from ava256_tpu_torch.models.bg import BackgroundModelSimple
from ava256_tpu_torch.models.bottleneck import VAEBottleneck
from ava256_tpu_torch.models.colorcal import Colorcal
from ava256_tpu_torch.models.decoders.assembler import DecoderAssembler
from ava256_tpu_torch.models.encoders.expression import ExpressionEncoder
from ava256_tpu_torch.models.encoders.identity import IdentityEncoder
from ava256_tpu_torch.models.raymarcher import Raymarcher
from ava256_tpu_torch.ops.grid_sample import resize_bilinear
from ava256_tpu_torch.ops.layers import remat
from ava256_tpu_torch.ops.raydirs import compute_raydirs


class Autoencoder(nn.Module):
    def __init__(self, identity_encoder: IdentityEncoder, expression_encoder: ExpressionEncoder,
                 bottleneck: VAEBottleneck, decoder_assembler: DecoderAssembler,
                 raymarcher: Raymarcher, colorcal: Optional[Colorcal] = None,
                 bgmodel: Optional[BackgroundModelSimple] = None):
        super().__init__()
        self.identity_encoder = identity_encoder
        self.expression_encoder = expression_encoder
        self.bottleneck = bottleneck
        self.decoder_assembler = decoder_assembler
        self.raymarcher = raymarcher  # holds no parameters
        self.colorcal = colorcal
        self.bgmodel = bgmodel

    def forward(
        self,
        camrot: torch.Tensor,  # [B, 3, 3]
        campos: torch.Tensor,  # [B, 3]
        focal: torch.Tensor,  # [B, 2]
        princpt: torch.Tensor,  # [B, 2]
        modelmatrix: torch.Tensor,  # [B, 4, 4] (or [B, 3, 4])
        avgtex: torch.Tensor,  # [B, M, M, 3]
        verts: torch.Tensor,  # [B, V, 3]
        neut_avgtex: torch.Tensor,
        neut_verts: torch.Tensor,
        target_neut_avgtex: Optional[torch.Tensor],
        target_neut_verts: Optional[torch.Tensor],
        pixelcoords: torch.Tensor,  # [B, H, W, 2]
        idindex: Optional[torch.Tensor] = None,
        camindex: Optional[torch.Tensor] = None,
        id_cond: Optional[Dict[str, Any]] = None,
        bg: Optional[torch.Tensor] = None,
        running_avg_scale: bool = False,
        gt_geo: Optional[torch.Tensor] = None,
        residuals_weight: float = 1.0,
        output_set: FrozenSet[str] = frozenset(),
        force_neutral: bool = False,
        alpha_mask: Optional[torch.Tensor] = None,
        deterministic: bool = False,
        render: bool = True,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        noise_rows: Optional[Tuple[int, int]] = None,
    ) -> Dict[str, Optional[torch.Tensor]]:
        """``generator`` (or an explicit ``noise`` [B, 4, 4, 16]) drives the
        bottleneck's sampling when not ``deterministic``; ``noise_rows``
        places the batch in a global one (``VAEBottleneck.forward``)."""
        if neut_verts is None or neut_avgtex is None:
            raise ValueError("Empty identity conditioning data")
        if id_cond is None:
            if target_neut_avgtex is None or target_neut_verts is None:
                raise ValueError("need target_neut_avgtex/verts or id_cond")
            id_cond = self.identity_encoder(target_neut_verts, target_neut_avgtex)

        expr_code = self.expression_encoder(verts=verts, avgtex=avgtex, neut_verts=neut_verts,
                                            neut_avgtex=neut_avgtex)
        if force_neutral:
            expr_code = torch.zeros_like(expr_code)
        expr_code, expr_mu, expr_logstd = self.bottleneck(
            expr_code, deterministic=deterministic, generator=generator, noise=noise,
            noise_rows=noise_rows)

        result: Dict[str, Optional[torch.Tensor]] = {
            "encoding": expr_code,
            "expr_mu": expr_mu,
            "expr_logstd": expr_logstd,
            "id_cond": id_cond if "idcond" in output_set else None,
        }
        result.update(self.decode(
            camrot=camrot, campos=campos, focal=focal, princpt=princpt,
            modelmatrix=modelmatrix, id_cond=id_cond, expr_encoding=expr_code,
            pixelcoords=pixelcoords, idindex=idindex, camindex=camindex, bg=bg,
            running_avg_scale=running_avg_scale, gt_geo=gt_geo,
            residuals_weight=residuals_weight, output_set=output_set,
            alpha_mask=alpha_mask, render=render))
        return result

    def decode(
        self,
        camrot: torch.Tensor,
        campos: torch.Tensor,
        focal: torch.Tensor,
        princpt: torch.Tensor,
        modelmatrix: torch.Tensor,
        id_cond: Dict[str, Any],
        expr_encoding: torch.Tensor,
        pixelcoords: torch.Tensor,
        idindex: Optional[torch.Tensor] = None,
        camindex: Optional[torch.Tensor] = None,
        bg: Optional[torch.Tensor] = None,
        running_avg_scale: bool = False,
        gt_geo: Optional[torch.Tensor] = None,
        residuals_weight: float = 1.0,
        output_set: FrozenSet[str] = frozenset(),
        alpha_mask: Optional[torch.Tensor] = None,
        render: bool = True,
    ) -> Dict[str, Optional[torch.Tensor]]:
        # model-relative viewing position: (campos - t) @ R
        viewpos = torch.einsum("ni,nij->nj", campos - modelmatrix[:, :3, 3],
                               modelmatrix[:, :3, :3])
        decout = self.decoder_assembler(id_cond, expr_encoding, viewpos,
                                        running_avg_scale=running_avg_scale, gt_geo=gt_geo,
                                        residuals_weight=residuals_weight)

        if alpha_mask is not None:
            # a [U, V] UV-space mask resampled to the primitive grid zeroes the
            # template alpha of masked primitives and culls them from the march
            nh = self.decoder_assembler.nh
            m = resize_bilinear(alpha_mask[None, :, :, None], (nh, nh))
            m = (m.reshape(1, nh * nh, 1, 1, 1, 1) > 0.5).to(decout["template"].dtype)
            tmpl = decout["template"]
            decout["template"] = torch.cat([tmpl[..., :3], tmpl[..., 3:4] * m], dim=-1)
            decout["prim_mask"] = m.reshape(1, nh * nh).expand(tmpl.shape[0], nh * nh)

        samplecoords = torch.cat([
            pixelcoords[..., :1] * 2.0 / (pixelcoords.shape[-2] - 1) - 1.0,
            pixelcoords[..., 1:] * 2.0 / (pixelcoords.shape[-3] - 1) - 1.0,
        ], dim=-1)

        if not render:
            return {
                "irgbrec": None,
                "verts": decout["verts"],
                "template": decout["template"],
                "primscale": decout["primscale"] if "primscale" in output_set else None,
                "samplecoords": samplecoords if "samplecoords" in output_set else None,
            }

        raypos, raydir, tminmax = compute_raydirs(campos, camrot, focal, princpt, pixelcoords,
                                                  self.raymarcher.volume_radius)
        rayrgb, rayalpha, _ = self.raymarcher(raypos, raydir, tminmax, decout)

        if self.colorcal is not None and camindex is not None and idindex is not None:
            rayrgb = self.colorcal(rayrgb, camindex, idindex)
        if bg is None and (self.bgmodel is not None and camindex is not None
                           and idindex is not None):
            bg = remat(self.bgmodel, camindex, idindex, samplecoords)
        if bg is not None:
            rayrgb = rayrgb + (1.0 - rayalpha) * bg

        return {
            "irgbrec": rayrgb,
            "verts": decout["verts"],
            "primscale": decout["primscale"] if "primscale" in output_set else None,
            "samplecoords": samplecoords if "samplecoords" in output_set else None,
            "bg": bg if "bg" in output_set else None,
            "ialpha": rayalpha if "ialpha" in output_set else None,
            "march_inputs": (
                {
                    "raypos": raypos, "raydir": raydir, "tminmax": tminmax,
                    "stepsize": self.raymarcher.dt, "primpos": decout["primpos"],
                    "primrot": decout["primrot"], "primscale": decout["primscale"],
                    "template": decout["template"], "warp": decout.get("warp"),
                    "prim_mask": decout.get("prim_mask"),
                }
                if "march_inputs" in output_set else None
            ),
        }
