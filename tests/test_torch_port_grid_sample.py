# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""``ava256_tpu_torch.ops.grid_sample.GridSample``, the autograd function in
front of the grid-sample kernels (``csrc/grid_sample.cu``), on its CPU route:

- it equals ``F.grid_sample`` and that op's own backward bit for bit (its
  plain version);
- it is held to the JAX package's ``ava256_tpu.ops.grid_sample`` (both of its
  forms) at 1e-5 on the outputs and at cosine > 0.9999 on the gradients
  (jax.vjp), with samples beyond the border and on half-pixel positions, at
  the shapes of both call sites: a level of the identity encoder's bias
  pyramid sampled on a warp grid shared by the batch, and the geometry
  decoder's vertex sampling ([N, V, 1, 2]);
- it refuses bfloat16 and float64 with an error that says so.

The kernels themselves run on the card: ``tests/test_torch_port_cuda.py``
and ``chip_smoke.py`` ``[grid-sample]``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ava256_tpu_torch.ops import grid_sample as gs

from tests import _torch_port_threads  # noqa: F401
from ava256_tpu.ops import grid_sample as jgs

OUT_TOL, GRAD_COS = 1e-5, 0.9999


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / np.sqrt((a @ a) * (b @ b)))


def _identity_level(rng):
    """A pyramid level [2, 16, 16, 32] and a warp grid shared by the batch:
    an identity grid plus a small bias, as the identity encoder makes it."""
    img = rng.randn(2, 16, 16, 32).astype(np.float32)
    xs = np.linspace(-1.0, 1.0, 16, dtype=np.float32)
    xg, yg = np.meshgrid(xs, xs)
    grid = np.stack([xg, yg], -1)[None] + 0.05 * rng.randn(1, 16, 16, 2).astype(np.float32)
    return img, np.repeat(grid, 2, axis=0).astype(np.float32)


def _vertex_sampling(rng):
    """A geometry map [2, 32, 32, 3] sampled at 50 vertices [2, 50, 1, 2]."""
    img = rng.randn(2, 32, 32, 3).astype(np.float32)
    return img, rng.uniform(-1.0, 1.0, (2, 50, 1, 2)).astype(np.float32)


def _border(rng):
    """Samples beyond the border (up to 1.3) and exactly on half-pixel
    positions (source coordinates k + 0.5 with align_corners False)."""
    img = rng.randn(2, 9, 11, 4).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 6, 7, 2)).astype(np.float32)
    # x = (2 * (k + 0.5) + 1) / W - 1 puts the source at k + 0.5
    kx = rng.randint(-2, 12, size=(2, 3, 7))
    ky = rng.randint(-2, 10, size=(2, 3, 7))
    grid[:, :3, :, 0] = (2.0 * (kx + 0.5) + 1.0) / 11 - 1.0
    grid[:, :3, :, 1] = (2.0 * (ky + 0.5) + 1.0) / 9 - 1.0
    return img, grid


CASES = {"identity_level": _identity_level, "vertex_sampling": _vertex_sampling,
         "border_and_half_pixel": _border}


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_cpu_route_is_f_grid_sample(case):
    """The CPU route is the plain version: F.grid_sample and its backward,
    bit for bit, gradients to the image and the grid."""
    img, grid = CASES[case](np.random.RandomState(1))
    gout = np.random.RandomState(2).randn(img.shape[0], *grid.shape[1:3],
                                          img.shape[3]).astype(np.float32)
    outs = []
    for fn in ("function", "library"):
        i = torch.from_numpy(img).requires_grad_()
        g = torch.from_numpy(grid).requires_grad_()
        if fn == "function":
            out = gs.GridSample.apply(i, g, False)
        else:
            out = F.grid_sample(i.permute(0, 3, 1, 2), g, mode="bilinear", padding_mode="zeros",
                                align_corners=False).permute(0, 2, 3, 1)
        out.backward(torch.from_numpy(gout))
        outs.append((out.detach(), i.grad, g.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_function_matches_jax(case, packed):
    img, grid = CASES[case](np.random.RandomState(3))
    gout = np.random.RandomState(4).randn(img.shape[0], *grid.shape[1:3],
                                          img.shape[3]).astype(np.float32)
    ref, vjp = jax.vjp(lambda a, b: jgs.grid_sample_2d(a, b, align_corners=False,
                                                       packed=packed),
                       jnp.asarray(img), jnp.asarray(grid))
    ref_img, ref_grid = vjp(jnp.asarray(gout))
    i = torch.from_numpy(img).requires_grad_()
    g = torch.from_numpy(grid).requires_grad_()
    out = gs.grid_sample_2d(i, g, align_corners=False)
    out.backward(torch.from_numpy(gout))
    ref = np.asarray(ref)
    assert np.abs(out.detach().numpy() - ref).max() <= OUT_TOL * (1.0 + np.abs(ref).max())
    assert _cos(i.grad.numpy(), ref_img) > GRAD_COS
    assert _cos(g.grad.numpy(), ref_grid) > GRAD_COS


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_function_refuses_other_dtypes(dtype):
    img = torch.zeros((1, 4, 4, 2), dtype=dtype)
    grid = torch.zeros((1, 3, 3, 2), dtype=dtype)
    with pytest.raises(ValueError, match="float32"):
        gs.GridSample.apply(img, grid, False)
    with pytest.raises(ValueError, match="float32"):
        gs.grid_sample_2d(img, grid)  # the promoted dtype is still not float32


def test_bfloat16_image_on_float32_grid_is_promoted():
    """What the bfloat16 model does: a bfloat16 pyramid level on the float32
    warp grid samples in float32, equal to sampling its float32 values."""
    img, grid = _identity_level(np.random.RandomState(5))
    low = torch.from_numpy(img).to(torch.bfloat16)
    out = gs.grid_sample_2d(low, torch.from_numpy(grid))
    assert out.dtype == torch.float32
    assert torch.equal(out, gs.grid_sample_plain(low.float(), torch.from_numpy(grid)))


# ---------------------------------------------------------------------------
# the kernels' fixed-point image gradient, the owner route's premise and the
# launch plans, restated and checked on the CPU (the kernels run on the card)
# ---------------------------------------------------------------------------

BWD_TOL, BWD_COS = 2e-5, 0.99999  # the backward limits of chip_smoke.py and the card tests


def _np_corners(grid, h, w, align):
    """Corners and weights of each sample in numpy float32, each operation
    rounded on its own in PyTorch's order."""
    f32 = np.float32
    x1, y1 = grid[..., 0].astype(f32) + f32(1), grid[..., 1].astype(f32) + f32(1)
    if align:
        ix, iy = (x1 * f32(0.5)) * f32(w - 1), (y1 * f32(0.5)) * f32(h - 1)
    else:
        ix, iy = (x1 * f32(w) - f32(1)) * f32(0.5), (y1 * f32(h) - f32(1)) * f32(0.5)
    fx, fy = np.floor(ix), np.floor(iy)
    ax, ay, ex, ey = (fx + f32(1)) - ix, (fy + f32(1)) - iy, ix - fx, iy - fy
    near = (fx > -2) & (fx < w + 1) & (fy > -2) & (fy < h + 1)
    x0 = np.where(near, fx, -2).astype(np.int64)
    y0 = np.where(near, fy, -2).astype(np.int64)
    out = []
    for (dy, dx), wt in zip(((0, 0), (0, 1), (1, 0), (1, 1)),
                            (ax * ay, ex * ay, ax * ey, ex * ey)):
        cx, cy = x0 + dx, y0 + dy
        out.append((cx, cy, wt, near & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)))
    return x0, y0, out


def _np_fixed_bwd(img, grid, gout, scale, align):
    """The image gradient as the kernels define it, in numpy: int64 sums of
    rint(w * gout * scale) (np.add.at), times 1 / scale."""
    n, h, w, c = img.shape
    scale = np.float32(scale)
    table = np.zeros(n * h * w * c, np.int64)
    b = np.arange(n).reshape(-1, 1, 1)
    for cx, cy, wt, ok in _np_corners(grid, h, w, align)[2]:
        x = (wt[..., None] * gout.astype(np.float32)) * scale
        good = ok[..., None] & (np.abs(x) < np.float32(2.0**62))
        q = np.rint(np.where(good, x, np.float32(0))).astype(np.int64)
        cell = ((b * h + np.clip(cy, 0, h - 1)) * w + np.clip(cx, 0, w - 1)) * c
        np.add.at(table, (cell[..., None] + np.arange(c)).ravel(), q.ravel())
    return table.astype(np.float32).reshape(n, h, w, c) * np.float32(1.0 / scale)


def _fixed_case(rng, c, align):
    """An image [2, 9, 11, c], and a grid [2, 6, 7, 2] past the border (to
    1.3) with its first rows on half-pixel source positions."""
    img = rng.randn(2, 9, 11, c).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 6, 7, 2)).astype(np.float32)
    kx = rng.randint(-2, 12, size=(2, 3, 7))
    ky = rng.randint(-2, 10, size=(2, 3, 7))
    if align:  # x = 2 (k + 0.5) / (W - 1) - 1 puts the source at k + 0.5
        grid[:, :3, :, 0] = 2.0 * (kx + 0.5) / 10 - 1.0
        grid[:, :3, :, 1] = 2.0 * (ky + 0.5) / 8 - 1.0
    else:
        grid[:, :3, :, 0] = (2.0 * (kx + 0.5) + 1.0) / 11 - 1.0
        grid[:, :3, :, 1] = (2.0 * (ky + 0.5) + 1.0) / 9 - 1.0
    gout = rng.randn(2, 6, 7, c).astype(np.float32)
    return img, grid, gout


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("c", [1, 3, 16, 64])
def test_fixed_point_backward_plain_equals_numpy(c, align):
    """grid_sample_bwd_fixed_plain, the plain version of the kernels' image
    gradient, equals its numpy restatement bit for bit, at the scale
    fixed_point.scale_for gives sum |gout| and at a coarser one."""
    from ava256_tpu_torch.ops import fixed_point

    img, grid, gout = _fixed_case(np.random.RandomState(10 + c), c, align)
    bound = torch.from_numpy(gout).abs().sum(dtype=torch.float64)
    for scale in (fixed_point.scale_for(bound), torch.tensor(2.0**20)):
        got = gs.grid_sample_bwd_fixed_plain(torch.from_numpy(img), torch.from_numpy(grid),
                                             torch.from_numpy(gout), scale, align)
        want = _np_fixed_bwd(img, grid, gout, float(scale), align)
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


def test_fixed_point_backward_plain_nan_scale_reads_nan():
    img, grid, gout = _fixed_case(np.random.RandomState(4), 3, False)
    got = gs.grid_sample_bwd_fixed_plain(torch.from_numpy(img), torch.from_numpy(grid),
                                         torch.from_numpy(gout), torch.tensor(float("nan")))
    assert torch.isnan(got).all()


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fixed_point_backward_plain_matches_f_grid_sample_and_jax(case, align):
    """The fixed-point image gradient against F.grid_sample's backward at the
    backward limits, and against jax.vjp of the JAX package's grid sample
    (both forms; align_corners False, its only mode) at cosine > 0.9999."""
    from ava256_tpu_torch.ops import fixed_point

    img, grid = CASES[case](np.random.RandomState(7))
    gout = np.random.RandomState(8).randn(img.shape[0], *grid.shape[1:3],
                                          img.shape[3]).astype(np.float32)
    ti, tg, to = (torch.from_numpy(x) for x in (img, grid, gout))
    scale = fixed_point.scale_for(to.abs().sum(dtype=torch.float64))
    got = gs.grid_sample_bwd_fixed_plain(ti, tg, to, scale, align).double()
    ref = gs.grid_sample_bwd_plain(ti, tg, to, align)[0].double()
    assert float((got - ref).abs().max() / ref.abs().max()) <= BWD_TOL
    assert _cos(got.numpy(), ref.numpy()) > BWD_COS
    if align:
        return
    for packed in (False, True):
        _, vjp = jax.vjp(lambda a, b: jgs.grid_sample_2d(a, b, align_corners=False,
                                                         packed=packed),
                         jnp.asarray(img), jnp.asarray(grid))
        assert _cos(got.numpy(), np.asarray(vjp(jnp.asarray(gout))[0])) > GRAD_COS


def _brute_escapes(grid, h, w, tw, th, radius, align):
    """The owner route's premise counted pixel by pixel: a corner in the image
    whose tile's window (the tile moved by minus the displacement of its
    centre pixel's sample, widened by radius) does not hold the pixel."""
    x0, y0, corners = _np_corners(grid, h, w, align)
    count = 0
    for b in range(grid.shape[0]):
        for y in range(h):
            for x in range(w):
                bad = False
                for cx, cy, _, ok in corners:
                    if not ok[b, y, x]:
                        continue
                    tx, ty = cx[b, y, x] // tw, cy[b, y, x] // th
                    px, py = min(tx * tw + tw // 2, w - 1), min(ty * th + th // 2, h - 1)
                    far = x0[b, py, px] == -2
                    sx = 0 if far else x0[b, py, px] - px
                    sy = 0 if far else y0[b, py, px] - py
                    wx, wy = x + sx - tx * tw, y + sy - ty * th
                    bad |= not (-radius <= wx < tw + radius and -radius <= wy < th + radius)
                count += bad
    return count


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("radius", [0, 1, 2])
def test_escape_count_plain_equals_brute_force(radius, align):
    """escape_count_plain (the restatement of the device count that picks
    the route) against a pixel-by-pixel count, on a stretched and jittered
    grid with samples past the border and far away."""
    rng = np.random.RandomState(radius)
    h, w = 12, 20
    ys, xs = np.meshgrid(np.linspace(-1.1, 1.1, h), np.linspace(-1.2, 1.0, w), indexing="ij")
    grid = np.stack([xs, ys], -1)[None].repeat(2, 0) + 0.25 * rng.randn(2, h, w, 2)
    grid[1, 3, 4] = (7.0, -9.0)  # far: reads nothing
    grid = grid.astype(np.float32)
    for tw, th in ((8, 4), (32, 8)):
        got = gs.escape_count_plain(torch.from_numpy(grid), h, w, tw, th, radius, align)
        assert got == _brute_escapes(grid, h, w, tw, th, radius, align)
        assert got > 0


def test_model_layouts_equal_contiguous_inputs():
    """GridSample on what the model hands it (an NHWC view of channels-first
    planes, a grid expanded over the batch, gout channels-first) equals the
    same values in contiguous tensors, gradients included."""
    rng = np.random.RandomState(12)
    planes = rng.randn(3, 16, 12, 10).astype(np.float32)
    warp = (rng.uniform(-1.1, 1.1, (1, 12, 10, 2))).astype(np.float32)
    gout = torch.from_numpy(rng.randn(3, 16, 12, 10).astype(np.float32)).permute(0, 2, 3, 1)
    runs = []
    for view in (True, False):
        p = torch.from_numpy(planes).requires_grad_()
        g = torch.from_numpy(warp).requires_grad_()
        img = p.permute(0, 2, 3, 1) if view else p.permute(0, 2, 3, 1).contiguous()
        grid = g.expand(3, -1, -1, -1) if view else g.expand(3, -1, -1, -1).contiguous()
        out = gs.GridSample.apply(img, grid, False)
        out.backward(gout if view else gout.contiguous())
        runs.append((out.detach().contiguous(), p.grad, g.grad))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _pyramid_calls(config):
    """(n, size, channels) of every warp level of the identity encoder, and
    the vertex sampling's image, for a config's batch and UV size."""
    from ava256_tpu_torch.config import load_config
    from ava256_tpu_torch.models.encoders import identity

    cfg = load_config(config)
    n, imsize = cfg["train"]["batchsize"], cfg["data"]["synthetic_texsize"]
    levels = [(n, imsize >> i, c) for i, c in
              enumerate(identity._BSIZE[: identity._nlayers(imsize)])]
    return n, imsize, levels


@pytest.mark.parametrize("config", ["configs/config-synthetic-flagship.yaml",
                                    "configs/config-synthetic-262k.yaml", "configs/config-4.yaml"])
def test_owner_plans_of_the_models_fit_the_card(config):
    """Every warp level of the flagship, 262k and config-4 models: the owner
    kernel's shared memory within 227 KB a block (and under the 48 KB that
    needs no opt-in), at most BLOCK cells a tile, window indices in 12 bits,
    the blocks' channel and batch groups covering every channel and item
    once, the grid gradient fused exactly when a block holds every channel."""
    n, imsize, levels = _pyramid_calls(config)
    assert imsize == 1024 and len(levels) == 8
    for n, s, c in levels:
        p = gs.owner_plan(n, s, s, c, shared=True)
        hn = (p["tw"] + 2 * p["radius"]) * (p["th"] + 2 * p["radius"])
        assert p["smem"] == 32 * hn + 8 * p["tw"] * p["th"] + 4
        assert p["smem"] <= min(gs.SMEM_LIMIT, 48 * 1024), (s, c, p)
        assert p["tw"] * p["th"] <= gs.BLOCK and hn < 4096
        assert p["tiles_x"] * p["tw"] >= s and p["tiles_y"] * p["th"] >= s
        assert (p["cgroups"] - 1) * p["cpg"] < c <= p["cgroups"] * p["cpg"]
        assert (p["bgroups"] - 1) * p["bpg"] < n <= p["bgroups"] * p["bpg"]
        assert p["fuse_grid"] == int(p["cgroups"] == 1)


def test_plan_routes_the_model_calls():
    """The model's calls as the wrapper plans them, without a card: a warp
    level (NHWC view of planes, expanded grid) takes the owner route with
    its strides as they come, the vertex sampling the scatter route; the
    outputs are planned in the image's memory format."""
    planes = torch.zeros(4, 16, 64, 64)
    img = planes.permute(0, 2, 3, 1)
    grid = torch.zeros(1, 64, 64, 2).expand(4, -1, -1, -1)
    gout = torch.zeros(4, 16, 64, 64).permute(0, 2, 3, 1)
    a = gs.plan(img, grid, False, gout=gout, out=img)
    assert a["route"] == 1 and a["shared"] == 1 and a["grid_n"] == 0
    assert (a["img_x"], a["img_c"]) == (1, 64 * 64) and a["out_c"] == 64 * 64
    assert gs.channels_first(img) and not gs.channels_first(img.contiguous())
    geo = torch.zeros(4, 3, 32, 32).permute(0, 2, 3, 1)
    coords = torch.zeros(1, 50, 1, 2).expand(4, -1, -1, -1)
    v = gs.plan(geo, coords, False, gout=torch.zeros(4, 50, 1, 3), out=geo)
    assert v["route"] == 0 and v["sc_lanes"] == 1
    with pytest.raises(ValueError, match="owner route"):
        gs.plan(geo, coords, False, route="owner")


@pytest.mark.parametrize("size", [8, 16, 32, 256])
def test_plan_picks_the_owner_route_from_its_least_size(size):
    """A warp level takes the owner route from OWNER_MIN_PIXELS pixels up
    and the scatter route below (where the card measured it faster); either
    may be forced on a warp level."""
    img = torch.zeros(4, 16, size, size).permute(0, 2, 3, 1)
    grid = torch.zeros(1, size, size, 2).expand(4, -1, -1, -1)
    a = gs.plan(img, grid, False, gout=img, out=img)
    assert a["route"] == int(size * size >= gs.OWNER_MIN_PIXELS)
    assert a["ncnt"] == (-(-size * size // gs.BLOCK) if a["route"] else 0)
    for route in ("owner", "scatter"):
        assert gs.plan(img, grid, False, gout=img, out=img, route=route)["route"] == (
            route == "owner")


def test_plan_reads_channels_last_gout_four_channels_at_a_time():
    """The owner kernel takes gout and the image gradient four channels a
    16-byte load where both are channels-last, C % 4 == 0 and gout is
    aligned; not for planes, C = 3, a misaligned gout or the scatter route."""
    def planned(c, layout="packed", offset=0, route=None):
        shape = (4, 64, 64, c)
        x = (torch.zeros(4 * 64 * 64 * c + offset)[offset:].view(shape) if layout == "packed"
             else torch.zeros(4, c, 64, 64).permute(0, 2, 3, 1))
        grid = torch.zeros(1, 64, 64, 2).expand(4, -1, -1, -1)
        return gs.plan(x, grid, False, gout=x, out=x, route=route)["owner_vec4"]

    assert planned(16) == planned(64) == 1
    assert planned(16, "planes") == planned(3) == planned(16, offset=1) == 0
    assert planned(16, route="scatter") == 0


def test_plan_collapses_gout_for_the_scale_sum():
    """The scale's sum walks gout as it comes: dense layouts fold to one
    dimension, an expanded gout (autograd's for a sum) to stride 0."""
    dense = torch.zeros(4, 16, 8, 8).permute(0, 2, 3, 1)
    assert gs._flat_dims(dense) == ([1, 1, 1, 4 * 16 * 64], [0, 0, 0, 1])
    assert gs._flat_dims(torch.ones(()).expand(4, 8, 8, 16)) == ([1, 1, 1, 4096], [0, 0, 0, 0])
    sizes, strides = gs._flat_dims(torch.zeros(4, 10, 8, 16)[:, 1:9])
    assert np.prod(sizes) == 4 * 8 * 8 * 16 and strides[-1] == 1


def test_wrapper_refuses_offsets_past_32_bits():
    """The kernels index in 32 bits: the wrapper raises rather than copy."""
    big = torch.empty_strided((2**16, 2**15 + 1, 1, 1), (2**15 + 1, 1, 1, 1), device="meta")
    with pytest.raises(ValueError, match="32 bits"):
        gs._check_offsets(img=big)
    gs._check_offsets(img=big[: 2**15])  # half of it fits
