"""The plain reference of the avatar model: the Mixture-of-Volumetric-
Primitives autoencoder of Universal Codec Avatars (facebookresearch/ava-256)
in float32 PyTorch, with no kernels, no activation checkpoints and no
conditioning tables.

It is the benchmark's own frozen copy of the architecture that the measured
program implements: the identity encoder (two UNets, their cross-talk and a
learned warp of the bias pyramids), the expression encoder, the VAE
bottleneck, the geometry and RGB decoders, the primitive assembler (adaptive
primitive scale, TBN frames, SRT residuals), the colour calibration and the
background model. Grid sampling is ``F.grid_sample``, transposed
convolutions are ``F.conv_transpose2d`` and the march is ``march.py``.
Submodules and parameters carry the names of the program's, so that one
state dict of weights loads into both.

Every size follows from the configuration: the texture size (``uv_res``),
the primitive count and size, the cameras and identities. With ``uv=None``
the model holds its parameters only (on the ``meta`` device, to learn their
shapes, or to count operations).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import march

LEAKY_GAIN = math.sqrt(2.0 / (1.0 + 0.2 * 0.2))
_PRIMSCALE_TABLE = {1: 2.0, 8: 4.0, 64: 8.0, 256: 12.0, 512: 16.0, 4096: 32.0,
                    16384: 48.0, 32768: 64.0, 262144: 128.0}
_ADAPTIVE_NPRIMS = (256, 16384)


def leaky_relu(x):
    return torch.where(x >= 0, x, 0.2 * x)


def nhwc_to_nchw(x):
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x):
    return x.permute(0, 2, 3, 1)


def xavier_bound(gain: float, fan_in: int, fan_out: int, ksize: int) -> float:
    return gain * math.sqrt(2.0 / ((fan_in + fan_out) * ksize)) * math.sqrt(3.0)


class _Layer(nn.Module):
    """A weight (drawn Uniform(-bound, bound)), an optional bias (zero at
    init) and, with weight norm, a per-output-channel gain ``g``: the
    effective weight is ``weight * g / ||weight||_F``."""

    channel_axis = 0

    def __init__(self, shape, bound: float, nout: int, wn: bool, bias: bool = True):
        super().__init__()
        self.bound = bound
        self.weight = nn.Parameter(torch.zeros(shape))
        self.g = nn.Parameter(torch.ones(nout)) if wn else None
        self.bias = nn.Parameter(torch.zeros(nout)) if bias else None

    def w(self):
        if self.g is None:
            return self.weight
        shape = [1] * self.weight.ndim
        shape[self.channel_axis] = -1
        return self.weight * (self.g / torch.sqrt(torch.sum(self.weight ** 2))).reshape(shape)


class LinearWN(_Layer):
    def __init__(self, cin, cout, gain=1.0, wn=True):
        super().__init__((cout, cin), xavier_bound(gain, cin, cout, 1), cout, wn)

    def forward(self, x):
        return F.linear(x, self.w(), self.bias)


class Conv2dWN(_Layer):
    def __init__(self, cin, cout, k=1, s=1, p=0, gain=1.0, wn=True):
        super().__init__((cout, cin, k, k), xavier_bound(gain, cin, cout, k * k), cout, wn)
        self.s, self.p = s, p

    def forward(self, x):
        return F.conv2d(x, self.w(), self.bias, self.s, self.p)


class ConvTranspose2dWN(_Layer):
    channel_axis = 1

    def __init__(self, cin, cout, k=4, s=2, p=1, gain=1.0):
        super().__init__((cin, cout, k, k), xavier_bound(gain, cin, cout, (k * k) // (s * s)),
                         cout, True)
        self.s, self.p = s, p

    def forward(self, x):
        return F.conv_transpose2d(x, self.w(), self.bias, self.s, self.p)


def Linear(cin, cout, gain=1.0):
    return LinearWN(cin, cout, gain, wn=False)


def Conv2d(cin, cout, gain=1.0):
    return Conv2dWN(cin, cout, 1, gain=gain, wn=False)


class ConvSeq(nn.Module):
    """(conv, leaky relu) pairs named ``Conv2dWN_<i>``; the last layer has no
    activation unless ``final_activation``."""

    def __init__(self, cin, specs, final_activation=False):
        super().__init__()
        self.n = len(specs)
        self.final_activation = final_activation
        for i, (cout, k, s, p) in enumerate(specs):
            act = i < len(specs) - 1 or final_activation
            setattr(self, f"Conv2dWN_{i}", Conv2dWN(cin, cout, k, s, p,
                                                    gain=LEAKY_GAIN if act else 1.0))
            cin = cout

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"Conv2dWN_{i}")(x)
            if i < self.n - 1 or self.final_activation:
                x = leaky_relu(x)
        return x


def generate_geomap(geo, uv_idx, uv_bary):
    """geo [N, V, 3] interpolated into a [N, M, M, 3] UV image."""
    m = uv_idx.shape[-1]
    out = 0.0
    for k in range(3):
        out = out + geo[:, uv_idx[k].reshape(-1)] * uv_bary[k].reshape(1, -1, 1)
    return out.reshape(geo.shape[0], m, m, 3)


def grid_sample(img_nhwc, grid):
    """Bilinear sampling, zero padding, align_corners False: [N, H, W, C] ->
    [N, Ho, Wo, C]."""
    out = F.grid_sample(nhwc_to_nchw(img_nhwc), grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return nchw_to_nhwc(out)


def resize_bilinear(img_nhwc, hw):
    out = F.interpolate(nhwc_to_nchw(img_nhwc), size=tuple(hw), mode="bilinear",
                        align_corners=False, antialias=False)
    return nchw_to_nhwc(out)


def rodrigues(rvec):
    theta = torch.sqrt(1e-5 + torch.sum(rvec ** 2, dim=-1))
    r = rvec / theta[..., None]
    c, s = torch.cos(theta), torch.sin(theta)
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    omc = 1.0 - c
    mat = torch.stack([x * x + (1.0 - x * x) * c, x * y * omc - z * s, x * z * omc + y * s,
                       x * y * omc + z * s, y * y + (1.0 - y * y) * c, y * z * omc - x * s,
                       x * z * omc - y * s, y * z * omc + x * s, z * z + (1.0 - z * z) * c],
                      dim=-1)
    return mat.reshape(rvec.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# encoders and bottleneck
# ---------------------------------------------------------------------------

_ESIZE = [3, 16, 32, 64, 64, 128, 128, 256, 256]


class UnetEncoder(nn.Module):
    def __init__(self, imsize):
        super().__init__()
        self.nlayers = int(np.log2(imsize)) - 2
        for i in range(self.nlayers):
            setattr(self, f"b{i}", Conv2dWN(_ESIZE[i], _ESIZE[i], 1,
                                            gain=LEAKY_GAIN if i > 0 else 1.0))
            setattr(self, f"e{i}", Conv2dWN(_ESIZE[i], _ESIZE[i + 1], 4, 2, 1, gain=LEAKY_GAIN))
        self.enc = Conv2dWN(_ESIZE[self.nlayers], 16, 1)

    def forward(self, x):
        biases = []
        for i in range(self.nlayers):
            b = getattr(self, f"b{i}")(x)
            biases.insert(0, leaky_relu(b) if i > 0 else b)
            x = leaky_relu(getattr(self, f"e{i}")(x))
        return self.enc(x), biases


class GeoTexCombiner(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.nlevels = len(channels)
        for i, ch in enumerate(channels):
            for name, cin in (("t2g", ch), ("g2t", ch), ("g", 2 * ch), ("t", 2 * ch)):
                setattr(self, f"{name}{i}", Conv2dWN(cin, ch, 1, gain=LEAKY_GAIN))

    def forward(self, b_geo, b_tex):
        out_geo, out_tex = [], []
        for i in range(self.nlevels):
            t2g = leaky_relu(getattr(self, f"t2g{i}")(b_tex[i]))
            g2t = leaky_relu(getattr(self, f"g2t{i}")(b_geo[i]))
            out_geo.append(leaky_relu(getattr(self, f"g{i}")(torch.cat([b_geo[i], t2g], 1))))
            out_tex.append(leaky_relu(getattr(self, f"t{i}")(torch.cat([b_tex[i], g2t], 1))))
        return out_geo, out_tex


class IdentityEncoder(nn.Module):
    def __init__(self, imsize, wsize=128):
        super().__init__()
        self.wsize = wsize
        self.geo = UnetEncoder(imsize)
        self.tex = UnetEncoder(imsize)
        self.comb = GeoTexCombiner(list(reversed(_ESIZE[: self.geo.nlayers])))
        self.warp_bias = nn.Parameter(torch.zeros(1, wsize, wsize, 2))

    def forward(self, neut_verts, neut_avgtex, uv):
        geo_img = generate_geomap(neut_verts, uv["uv_idx"], uv["uv_bary"])
        z_geo, b_geo = self.geo(nhwc_to_nchw(geo_img))
        z_tex, b_tex = self.tex(nhwc_to_nchw(neut_avgtex))
        b_geo, b_tex = self.comb(b_geo, b_tex)
        xs = torch.linspace(-1.0, 1.0, self.wsize, device=neut_verts.device)
        yg, xg = torch.meshgrid(xs, xs, indexing="ij")
        warp = torch.stack([xg, yg], dim=-1)[None] + self.warp_bias / self.wsize
        n = neut_verts.shape[0]

        def warped(levels):
            return [grid_sample(nchw_to_nhwc(x), resize_bilinear(warp, x.shape[2:]).expand(
                n, -1, -1, -1)) for x in levels]

        return {"z_geo": nchw_to_nhwc(z_geo), "z_tex": nchw_to_nhwc(z_tex),
                "b_geo": warped(b_geo), "b_tex": warped(b_tex)}


class ExpressionEncoder(nn.Module):
    def __init__(self, imsize):
        super().__init__()
        n_down = int(math.log2(imsize)) - 5
        self.tex = ConvSeq(3, [(16, 4, 2, 1), (32, 4, 2, 1), (64, 4, 2, 1)], True)
        self.geo = ConvSeq(3, [(16, 4, 2, 1), (32, 4, 2, 1), (32, 4, 2, 1)], True)
        lead = [(c, 4, 2, 1) for c in [128, 256, 256, 512][: n_down - 1]]
        self.comb = ConvSeq(96, lead + [(256, 3, 1, 1), (128, 3, 1, 1), (64, 3, 1, 1),
                                        (64, 4, 2, 1)], True)

    def forward(self, verts, avgtex, neut_verts, neut_avgtex, uv):
        geo_img = generate_geomap(verts - neut_verts, uv["uv_idx"], uv["uv_bary"])
        tex = self.tex(nhwc_to_nchw(avgtex - neut_avgtex))
        geo = self.geo(nhwc_to_nchw(geo_img))
        return nchw_to_nhwc(self.comb(torch.cat([tex, geo], dim=1)))


class VAEBottleneck(nn.Module):
    def __init__(self):
        super().__init__()
        self.mu = Conv2dWN(64, 16, 1)
        self.logstd = Conv2dWN(64, 16, 1)

    def forward(self, x, noise):
        xc = nhwc_to_nchw(x)
        mu = nchw_to_nhwc(self.mu(xc)) * 0.1
        logstd = nchw_to_nhwc(self.logstd(xc)) * 0.01
        z = mu if noise is None else mu + torch.exp(logstd) * noise
        return z, mu, logstd


def kl_loss_stable(mu, logstd):
    return torch.mean(-0.5 + torch.abs(logstd) + 0.5 * mu ** 2
                      + 0.5 * torch.exp(-2.0 * torch.abs(logstd)), dim=-1)


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------


def tower_sizes(imsize, inch, boxsize):
    return {1024: [inch, 256, 128, 128, 64, 64, 32, 16, boxsize],
            512: [inch, 128, 128, 64, 64, 32, 16, boxsize],
            256: [inch, 128, 64, 64, 32, 16, boxsize]}[imsize]


def add_bias(xx, pyramid):
    for b in pyramid:
        if b.shape[1] == xx.shape[2] and b.shape[-1] == xx.shape[1]:
            return (xx + nhwc_to_nchw(b)) * (1.0 / np.sqrt(2.0))
    return xx


class GeometryDecoder(nn.Module):
    def __init__(self, imsize, nboxes, boxsize, motion_size, geo_size):
        super().__init__()
        self.motion_size, self.geo_size = motion_size, geo_size
        self.nboxes, self.boxsize = nboxes, boxsize
        sizes = tower_sizes(imsize, 32, boxsize)
        self.nlayers = len(sizes) - 1
        self.encmod = Conv2dWN(16, 16, 1, gain=LEAKY_GAIN)
        for i in range(self.nlayers):
            setattr(self, f"t{i}", ConvTranspose2dWN(
                sizes[i], sizes[i + 1], gain=1.0 if i == self.nlayers - 1 else LEAKY_GAIN))
        ch_at = {8 * 2 ** i: sizes[i + 1] for i in range(self.nlayers)}
        self.motion0 = Conv2dWN(ch_at[motion_size], 64, 1, gain=LEAKY_GAIN)
        self.motion1 = Conv2dWN(64, 9, 1)
        self.geo0 = Conv2dWN(ch_at[geo_size], 64, 1, gain=LEAKY_GAIN)
        self.geo1 = Conv2dWN(64, 3, 1)
        self.slab_bias = nn.Parameter(torch.zeros(imsize, imsize, boxsize))

    def forward(self, ex_enc, id_enc, id_bias, vert_coords):
        n = ex_enc.shape[0]
        x = torch.cat([leaky_relu(self.encmod(nhwc_to_nchw(ex_enc))), nhwc_to_nchw(id_enc)], 1)
        mot = geo_map = None
        for i in range(self.nlayers):
            xx = getattr(self, f"t{i}")(x)
            if i < self.nlayers - 1:
                xx = leaky_relu(xx)
            x = add_bias(xx, id_bias)
            if x.shape[2] == self.motion_size:
                mot = self.motion1(leaky_relu(self.motion0(x)))
            if x.shape[2] == self.geo_size:
                geo_map = self.geo1(leaky_relu(self.geo0(x)))
        slab = torch.exp((nchw_to_nhwc(x) + self.slab_bias[None]) * 0.1)
        mot = nchw_to_nhwc(mot).reshape(n, self.nboxes, 9) * 0.01
        geo = torch.mean(grid_sample(nchw_to_nhwc(geo_map),
                                     vert_coords[None].expand(n, -1, -1, -1)), dim=2)
        bs, nh = self.boxsize, int(np.sqrt(self.nboxes))
        opacity = slab.reshape(n, nh, bs, nh, bs, bs).permute(0, 1, 3, 5, 2, 4)
        return (opacity.reshape(n, self.nboxes, bs, bs, bs, 1), geo, mot[..., 0:3],
                mot[..., 3:6], torch.exp(mot[..., 6:9]))


class RGBDecoder(nn.Module):
    def __init__(self, imsize, nboxes, boxsize):
        super().__init__()
        self.nboxes, self.boxsize = nboxes, boxsize
        sizes = tower_sizes(imsize, 40, boxsize * 3)
        self.nlayers = len(sizes) - 1
        self.encmod = Conv2dWN(16, 16, 1, gain=LEAKY_GAIN)
        self.viewmod0 = LinearWN(3, 16, gain=LEAKY_GAIN)
        self.viewmod1 = LinearWN(16, 128, gain=LEAKY_GAIN)
        for i in range(self.nlayers):
            setattr(self, f"t{i}", ConvTranspose2dWN(
                sizes[i], sizes[i + 1], gain=1.0 if i == self.nlayers - 1 else LEAKY_GAIN))
        self.slab_bias = nn.Parameter(torch.zeros(imsize, imsize, boxsize * 3))

    def forward(self, ex_code, id_code, id_biases, view):
        n = ex_code.shape[0]
        x = torch.cat([leaky_relu(self.encmod(nhwc_to_nchw(ex_code))), nhwc_to_nchw(id_code)], 1)
        v = leaky_relu(self.viewmod1(leaky_relu(self.viewmod0(view))))
        x = torch.cat([v.reshape(n, 4, 4, 8).permute(0, 3, 1, 2), x], dim=1)
        for i in range(self.nlayers):
            xx = getattr(self, f"t{i}")(x)
            if i < self.nlayers - 1:
                xx = leaky_relu(xx)
            x = add_bias(xx, id_biases)
        tex = nchw_to_nhwc(x) + self.slab_bias[None]
        bs, nh = self.boxsize, int(np.sqrt(self.nboxes))
        rgb = tex.reshape(n, nh, bs, nh, bs, bs, 3).permute(0, 1, 3, 5, 2, 4, 6)
        return rgb.reshape(n, self.nboxes, bs, bs, bs, 3)


def _unit(v):
    return v / torch.clamp(torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)), min=1e-8)


def tbn_frames(postex, nh, s):
    """TBN frames at the centre texel of each s x s block of the position
    map, from forward differences along u and v (at s = 2 they cross into
    the next block, the last one duplicated at the map's edge)."""
    n, res = postex.shape[0], postex.shape[1]
    c = s // 2
    if c + 1 >= s:
        def diff(p):
            d = p[:, :, c + 1::s] - p[:, :, c:res - 1:s]
            return torch.cat([d, p[:, :, -1:] - p[:, :, -2:-1]], dim=2)

        du = diff(postex[:, c::s])
        dv = diff(postex[:, :, c::s].transpose(1, 2)).transpose(1, 2)
    else:
        blocks = postex.reshape(n, nh, s, nh, s, 3)
        ctr = blocks[:, :, c, :, c, :]
        du = blocks[:, :, c, :, c + 1, :] - ctr
        dv = blocks[:, :, c + 1, :, c, :] - ctr
    tangent = _unit(du)
    normal = _unit(torch.cross(tangent, dv, dim=-1))
    bitangent = _unit(torch.cross(normal, tangent, dim=-1))
    return torch.stack([tangent, bitangent, normal], dim=-1).reshape(n, nh * nh, 3, 3)


class DecoderAssembler(nn.Module):
    def __init__(self, uv_res, nprims, primsize, nverts):
        super().__init__()
        nh = int(round(math.sqrt(nprims)))
        self.nh, self.nprims, self.stride = nh, nprims, uv_res // nh
        imsize = nh * primsize
        self.rgbdec = RGBDecoder(imsize, nprims, primsize)
        self.geodec = GeometryDecoder(imsize, nprims, primsize,
                                      {256: 16, 16384: 128}.get(nprims, nh),
                                      256 if imsize > 256 else imsize // 2)
        self.register_buffer("adaptwarps", torch.zeros(nprims))
        self.nverts = nverts

    def forward(self, id_cond, expr, viewpos, uv, vertmean, vertstd, volradius,
                running_avg_scale, gt_geo, residuals_weight):
        n = expr.shape[0]
        K, s, nh = self.nprims, self.stride, self.nh
        c = s // 2
        opacity, geo, pos_r, rvec_r, scale_r = self.geodec(expr, id_cond["z_geo"],
                                                           id_cond["b_geo"], uv["vert_coords"])
        geo = geo * vertstd + vertmean
        predicted = geo
        if gt_geo is not None:
            geo = gt_geo * vertstd + vertmean
        postex = generate_geomap(geo, uv["idxim"], uv["barim"]) / volradius
        primpos = postex[:, c::s, c::s, :].reshape(n, K, 3)
        if K in _ADAPTIVE_NPRIMS:
            if running_avg_scale:
                cx = postex[:, c::s, c + s::s, :] - postex[:, c::s, c:-s:s, :]
                cx = torch.cat([cx, cx[:, :, -1:, :]], dim=2)
                cy = postex[:, c + s::s, c::s, :] - postex[:, c:-s:s, c::s, :]
                cy = torch.cat([cy, cy[:, -1:, :, :]], dim=1)
                cent = torch.maximum(torch.sqrt(torch.sum(cx * cx, -1)),
                                     torch.sqrt(torch.sum(cy * cy, -1)))
                warps = torch.clamp((2.0 / torch.amax(cent, dim=0).reshape(K)).detach(),
                                    min=nh / 12.8)
                old = self.adaptwarps
                self.adaptwarps.copy_(warps if bool(torch.amax(old) == 0.0)
                                      else old * 0.9 + 0.1 * warps)
            primscale = (self.adaptwarps * 0.8)[None, :, None].expand(n, K, 3)
        else:
            primscale = torch.full((n, K, 3), _PRIMSCALE_TABLE.get(K, 0.4 * nh),
                                   device=postex.device)
        primrot = tbn_frames(postex, nh, s)
        rw = min(max(float(residuals_weight), 0.0), 1.0)
        primpos = primpos + pos_r * rw
        primrot = torch.einsum("nkij,nkjl->nkil", primrot, rodrigues(rvec_r * rw))
        primscale = primscale * (scale_r * rw + (1.0 - rw))
        viewdirs = viewpos / torch.sqrt(torch.sum(viewpos ** 2, dim=1, keepdim=True))
        rgb = self.rgbdec(expr, id_cond["z_tex"], id_cond["b_tex"], viewdirs)
        template = torch.cat([torch.relu(rgb * 25.0 + 100.0), torch.relu(opacity)], dim=-1)
        return {"verts": predicted, "template": template, "primpos": primpos,
                "primrot": primrot, "primscale": primscale}


class Colorcal(nn.Module):
    def __init__(self, ncams, nident):
        super().__init__()
        self.wcam = nn.Parameter(torch.ones(ncams, 3))
        self.bcam = nn.Parameter(torch.zeros(ncams, 3))
        self.wident = nn.Parameter(torch.zeros(nident, 3))
        self.bident = nn.Parameter(torch.zeros(nident, 3))

    def forward(self, image, camindex, idindex):
        w = self.wcam[camindex] + self.wident[idindex]
        b = self.bcam[camindex] + self.bident[idindex]
        return w[:, None, None, :] * image + b[:, None, None, :]


class BackgroundModelSimple(nn.Module):
    def __init__(self, ncams, nident):
        super().__init__()
        self.ncams, self.nident = ncams, nident
        self.cammod0 = Linear(ncams, 256, gain=LEAKY_GAIN)
        self.cammod1 = Linear(256, 40)
        self.idmod0 = Linear(nident, 256, gain=LEAKY_GAIN)
        self.idmod1 = Linear(256, 40)
        for i in range(5):
            setattr(self, f"mlp{i}", Conv2d(120 if i == 0 else 256, 256, gain=LEAKY_GAIN))
        self.mlp5 = Conv2d(256, 3)

    def forward(self, camindex, idindex, samplecoords):
        n, h, w = samplecoords.shape[:3]
        camenc = self.cammod1(leaky_relu(self.cammod0(
            F.one_hot(camindex.long(), self.ncams).float())))
        idenc = self.idmod1(leaky_relu(self.idmod0(
            F.one_hot(idindex.long(), self.nident).float())))
        freqs = (2.0 ** torch.arange(10, device=samplecoords.device, dtype=torch.float32)
                 ) * np.float32(np.pi)
        ang = samplecoords[..., None, :] * freqs[:, None]
        posenc = torch.cat([torch.sin(ang).reshape(n, h, w, -1),
                            torch.cos(ang).reshape(n, h, w, -1)], -1).permute(0, 3, 1, 2)
        x = torch.cat([camenc[:, :, None, None].expand(n, 40, h, w),
                       idenc[:, :, None, None].expand(n, 40, h, w), posenc], dim=1)
        for i in range(5):
            x = leaky_relu(getattr(self, f"mlp{i}")(x))
        return (self.mlp5(x) * 25.0 + 100.0).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# the autoencoder
# ---------------------------------------------------------------------------


def compute_raydirs(campos, camrot, focal, princpt, pixelcoords, volradius):
    p = (pixelcoords - princpt[:, None, None, :]) / focal[:, None, None, :]
    d = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    raydir = torch.einsum("nij,nhwi->nhwj", camrot, d)
    raydir = raydir / torch.sqrt(torch.sum(raydir ** 2, dim=-1, keepdim=True))
    raypos = (campos / volradius)[:, None, None, :] * torch.ones_like(raydir)
    t1 = (-1.0 - raypos) / raydir
    t2 = (1.0 - raypos) / raydir
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    return raypos, raydir, torch.stack([torch.clamp(tmin, min=0.0), tmax], dim=-1)


class Autoencoder(nn.Module):
    """``dims``: uv_res, nprims, primsize, nverts, ncams, nident, volradius,
    dt (the march step over the volume radius) and the march's tile,
    max_hit, nbuf, cull_group_size, cull_max_groups. ``uv``: uv_idx,
    uv_bary [3, M, M] (numpy) and the per-vertex UV coordinates, or None."""

    def __init__(self, dims: Dict, uv: Optional[Dict[str, np.ndarray]] = None,
                 vertmean: Optional[np.ndarray] = None, vertstd: float = 1.0):
        super().__init__()
        self.dims = dict(dims)
        m = dims["uv_res"]
        self.identity_encoder = IdentityEncoder(m)
        self.expression_encoder = ExpressionEncoder(m)
        self.bottleneck = VAEBottleneck()
        self.decoder_assembler = DecoderAssembler(m, dims["nprims"], dims["primsize"],
                                                  dims["nverts"])
        self.colorcal = Colorcal(dims["ncams"], dims["nident"])
        self.bgmodel = BackgroundModelSimple(dims["ncams"], dims["nident"])
        self.vertstd = float(vertstd)
        self.uv = None
        if uv is not None:
            self.uv = {"uv_idx": torch.as_tensor(uv["uv_idx"], dtype=torch.int64),
                       "uv_bary": torch.as_tensor(uv["uv_bary"], dtype=torch.float32),
                       "vert_coords": torch.as_tensor(uv["vert_coords"], dtype=torch.float32)}
            self.uv["idxim"], self.uv["barim"] = self.uv["uv_idx"], self.uv["uv_bary"]
            self.vertmean = torch.as_tensor(vertmean, dtype=torch.float32)

    def to_device(self, device):
        self.to(device)
        if self.uv is not None:
            self.uv = {k: v.to(device) for k, v in self.uv.items()}
            self.vertmean = self.vertmean.to(device)
        return self

    def forward(self, b, noise=None, running_avg_scale=False, gt_geo=None,
                residuals_weight=1.0, march_fn=None):
        """``b``: the full batch (camrot, campos, focal, princpt, modelmatrix,
        avgtex, verts, neut_avgtex, neut_verts, pixelcoords, idindex,
        camindex); the identity is that of ``target_neut_verts`` and
        ``target_neut_avgtex`` when the batch has them, else its own.
        ``noise`` [N, 4, 4, 16] samples the bottleneck; None takes its mean.
        ``march_fn`` stands in for the march (the operation count leaves it
        out). Returns irgbrec, verts, primscale, expr_mu, expr_logstd."""
        d, uv = self.dims, self.uv
        id_cond = self.identity_encoder(b.get("target_neut_verts", b["neut_verts"]),
                                        b.get("target_neut_avgtex", b["neut_avgtex"]), uv)
        expr = self.expression_encoder(b["verts"], b["avgtex"], b["neut_verts"],
                                       b["neut_avgtex"], uv)
        z, mu, logstd = self.bottleneck(expr, noise)
        mm = b["modelmatrix"]
        viewpos = torch.einsum("ni,nij->nj", b["campos"] - mm[:, :3, 3], mm[:, :3, :3])
        dec = self.decoder_assembler(id_cond, z, viewpos, uv, self.vertmean, self.vertstd,
                                     d["volradius"], running_avg_scale, gt_geo,
                                     residuals_weight)
        pc = b["pixelcoords"]
        samplecoords = torch.cat([pc[..., :1] * 2.0 / (pc.shape[-2] - 1) - 1.0,
                                  pc[..., 1:] * 2.0 / (pc.shape[-3] - 1) - 1.0], dim=-1)
        with torch.no_grad():
            raypos, raydir, tminmax = compute_raydirs(b["campos"], b["camrot"], b["focal"],
                                                      b["princpt"], pc, d["volradius"])
        fn = march_fn or march.mvp_march
        rgba = fn(raypos, raydir, tminmax, dec["primpos"], dec["primrot"], dec["primscale"],
                  dec["template"], dt=d["dt"], tile=d["tile"], max_hit=d["max_hit"],
                  nbuf=d["nbuf"], cull_group_size=d["cull_group_size"],
                  cull_max_groups=d["cull_max_groups"])
        rgb, alpha = rgba[..., 0:3], rgba[..., 3:4]
        rgb = self.colorcal(rgb, b["camindex"].long(), b["idindex"].long())
        bg = self.bgmodel(b["camindex"], b["idindex"], samplecoords)
        rgb = rgb + (1.0 - alpha) * bg
        return {"irgbrec": rgb, "verts": dec["verts"], "primscale": dec["primscale"],
                "expr_mu": mu, "expr_logstd": logstd}


def vertex_uv_coords(uv, tri, uvtri, nvtx):
    """Per-vertex UV sampling coordinates in [-1, 1], [nvtx, 1, 2]: the first
    UV coordinate any face gives the vertex, faces in order."""
    verts, at = np.unique(np.asarray(tri).reshape(-1), return_index=True)
    first = np.zeros(nvtx, np.int64)
    first[verts] = np.asarray(uvtri).reshape(-1)[at]
    return (np.asarray(uv)[first].astype(np.float32) * 2.0 - 1.0)[:, None, :]


def compute_losses(out, b, weights, vertmean, vertstd) -> Dict[str, torch.Tensor]:
    terms = {}
    if "irgbl1" in weights:
        terms["irgbl1"] = torch.mean(torch.abs(out["irgbrec"] - b["image"]))
    if "vertl1" in weights:
        terms["vertl1"] = torch.mean(torch.abs(out["verts"] - (b["verts"] * vertstd
                                                                 + vertmean)))
    if "primvolsum" in weights:
        terms["primvolsum"] = torch.mean(torch.sum(torch.prod(1.0 / out["primscale"], -1), -1))
    if "kldiv" in weights:
        terms["kldiv"] = torch.mean(kl_loss_stable(out["expr_mu"], out["expr_logstd"]))
    return terms


def total_loss(terms: Dict[str, torch.Tensor], weights: Dict[str, float]) -> torch.Tensor:
    return sum(weights[k] * v for k, v in terms.items())


def parameter_bounds(model: nn.Module) -> Dict[str, float]:
    """Name of each layer weight -> the bound of its Uniform draw."""
    return {f"{name}.weight": mod.bound for name, mod in model.named_modules()
            if isinstance(mod, _Layer)}


def weight_norm_gains(model: nn.Module) -> List[str]:
    return [f"{name}.g" for name, mod in model.named_modules()
            if isinstance(mod, _Layer) and mod.g is not None]
