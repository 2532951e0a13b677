# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The hand-over of the forward march's saturation state to the backward, and
the rays' own row ranges, in the port's raymarch
(ava256_tpu_torch.ops.raymarch_cuda) on the CPU, where the wrappers run the
kernels' plain PyTorch versions.

- ``march_tiles_plain`` with the state output returns the same RGBA, bit for
  bit, and a state that says what the composite did; a tile marches alone
  (its own windows and early exit, as the kernels' block);
- the op's five gradients are the same, bit for bit, whether the backward is
  handed the forward's saved state or derives it itself, on the scenes of the
  backward tests (saturating, early-out, nbuf truncation, warp, prim_mask,
  primsize 2/4/8/16);
- the op asks for the state only when a gradient is needed, and with it its
  gradients still agree with ``mvp_raymarch_pallas`` in interpret mode
  (cosine > 0.9999, max |d| <= 1e-3 max |ref|);
- ``ray_candidates_plain``, the rows each thread of the kernels walks: every
  sample the march accepts lies inside them;
- what ``_check_tiles`` refuses: a misaligned template table, a state of the
  wrong shape or on another device;
- a trilinear corner outside the box reads zero whatever lies in the cell its
  index is clamped to, a non-finite value included, and the backward's
  fixed-point bound, taken over the cells the forward read, is finite and
  leaves the negative-density bit clear there (a read inf cell makes it
  non-finite); that bound holds on the small scenes.
"""

import numpy as np
import pytest

import torch

from ava256_tpu_torch.data.synthetic import raymarch_scene
from ava256_tpu_torch.ops import fixed_point
from ava256_tpu_torch.ops import raymarch_cuda as rc
from ava256_tpu_torch.ops.math3d import rodrigues

from tests import _torch_port_threads  # noqa: F401
from tests.test_torch_port_raymarch_bwd import CASES, NAMES, _assert_grads_close, _grads_both


def _synthetic(bs, warp=False, opaque=False):
    s = raymarch_scene(n=1, h=17, w=19, k3=2, bs=bs, warp=warp, seed=bs)
    if opaque:
        s["template"][..., 3] *= 30.0
    s["primrot"] = rodrigues(torch.from_numpy(s["primrvec"])).numpy()
    return s, dict(tile=8, max_hit=8, nbuf=64, warp=warp)


SCENES = dict(CASES)
SCENES.update({
    "bs4_warp": lambda: _synthetic(4, warp=True),
    "bs8_saturating": lambda: _synthetic(8, opaque=True),
    "bs16": lambda: _synthetic(16),
})


def _tiles(s, warp=False, prim_mask=None, tile=8, max_hit=8, nbuf=64, **_):
    """The arguments of ``march_tiles`` for a scene, culled as the op culls."""
    t = {k: torch.from_numpy(np.array(s[k])) for k in
         ("raypos", "raydir", "tminmax", "primpos", "primrot", "primscale", "template")}
    dt = float(s["stepsize"])
    tmm = t["tminmax"]
    tmm = torch.stack([tmm[..., 0], torch.minimum(tmm[..., 1], tmm[..., 0] + nbuf * dt)], -1)
    n, K = t["primpos"].shape[:2]
    bs = t["template"].shape[2]
    pm = torch.ones(n, K) if prim_mask is None else torch.from_numpy(prim_mask)
    t_o, t_d, t_mm, gid, valid, _, _ = rc.tile_and_cull(
        t["raypos"], t["raydir"], tmm, t["primpos"], t["primscale"], pm, tile, max_hit, dt)
    scal = rc.candidate_affines(t["primpos"], t["primrot"].reshape(n, K, 3, 3), t["primscale"],
                                gid, valid)
    wrp = torch.from_numpy(np.array(s["warp"])).reshape(n * K, bs, bs, bs, 3) if warp else None
    return (gid.to(torch.int32), scal, t_o, t_d, t_mm,
            t["template"].reshape(n * K, bs, bs, bs, 4).contiguous(), wrp, dt, 6.5, 8.0, nbuf)


@pytest.mark.parametrize("case", ["adversarial_early_out", "bs8_saturating", "plain_rows8",
                                  "nbuf_truncation", "bs4_warp"])
def test_state_output_leaves_rgba_alone(case):
    s, kw = SCENES[case]()
    args = _tiles(s, **kw)
    out = rc.march_tiles_plain(*args)
    out2, state = rc.march_tiles(*args, with_state=True)
    assert torch.equal(out, out2)
    assert state.shape == (out.shape[0], rc.STATE_ROWS, out.shape[2])
    assert torch.equal(state[:, 4], out[:, 3])
    # the saturation row's sums are there exactly for the rays that saturated
    saturated = out[:, 3] >= 1.0
    assert torch.equal(state[:, 3] > 0, saturated)
    assert float((state[:, :4] * (~saturated)[:, None]).abs().max()) == 0.0
    if case in ("adversarial_early_out", "bs8_saturating"):
        assert bool(saturated.any()) and not bool(saturated.all())


@pytest.mark.parametrize("case", ["adversarial_early_out", "bs8_saturating", "bs4_warp"])
def test_each_tile_marches_alone(case):
    """The kernels' block marches its tile's windows from the tile's own
    first row and stops at the end of the first one after which every ray is
    done: a tile's output, state (the extremes of the cells it read
    included) and sample count do not depend on the other tiles of the call."""
    s, kw = SCENES[case]()
    args = _tiles(s, **kw)
    counts = {}
    out, state = rc.march_tiles_plain(*args, counts=counts, with_state=True)
    total = 0
    for i in range(args[0].shape[0]):
        one = {}
        tile = tuple(x[i:i + 1] for x in args[:5]) + args[5:]
        o, st = rc.march_tiles_plain(*tile, counts=one, with_state=True)
        assert torch.equal(o, out[i:i + 1]) and torch.equal(st, state[i:i + 1]), i
        total += int(one.get("samples", 0))
    assert total == int(counts["samples"]) > 0
    assert float(state[:, 5].max()) > 0


def _op_grads(s, with_state, monkeypatch, warp=False, prim_mask=None, **kw):
    """The op's five gradients on the CPU; ``with_state=False`` makes the
    forward keep no state, so that the backward derives it itself."""
    if not with_state:
        real = rc.march_tiles

        def stateless(*a, with_state=False, **k):
            out = real(*a, with_state=False, **k)
            return (out, None) if with_state else out

        monkeypatch.setattr(rc, "march_tiles", stateless)
    names = NAMES[: 5 if warp else 4]
    rp, rd, tmm = (torch.from_numpy(np.array(s[k])) for k in ("raypos", "raydir", "tminmax"))
    leaves = [torch.from_numpy(np.array(s[k])).requires_grad_() for k in names]
    out = rc.mvp_raymarch_cuda(
        rp, rd, s["stepsize"], tmm, *leaves[:4], leaves[4] if warp else None,
        prim_mask=None if prim_mask is None else torch.from_numpy(prim_mask), device="cpu",
        fadescale=6.5, fadeexp=8.0, **kw)
    g = torch.from_numpy(np.random.RandomState(2).randn(*out.shape).astype(np.float32))
    saved = out.grad_fn.saved_tensors[-1]
    (out * g).sum().backward()
    monkeypatch.undo()
    return [x.grad for x in leaves], saved


@pytest.mark.parametrize("case", sorted(SCENES))
def test_backward_same_with_saved_state(case, monkeypatch):
    s, kw = SCENES[case]()
    kw.pop("rows", None)
    got, saved = _op_grads(s, True, monkeypatch, **kw)
    ref, none = _op_grads(s, False, monkeypatch, **kw)
    assert none is None and saved is not None and saved.shape[1] == rc.STATE_ROWS
    assert len(got) == (5 if kw.get("warp") else 4)
    for name, a, b in zip(NAMES, got, ref):
        assert float(b.abs().max()) > 0, name
        assert torch.equal(a, b), name


def test_op_keeps_state_only_for_gradients(monkeypatch):
    s, kw = CASES["adversarial_early_out"]()
    asked = []
    real = rc.march_tiles

    def spy(*a, with_state=False, **k):
        asked.append(with_state)
        return real(*a, with_state=with_state, **k)

    monkeypatch.setattr(rc, "march_tiles", spy)
    rp, rd, tmm, *prims = (torch.from_numpy(np.array(s[k]))
                           for k in ("raypos", "raydir", "tminmax") + NAMES[:4])
    out = rc.mvp_raymarch_cuda(rp, rd, s["stepsize"], tmm, *prims, None, device="cpu",
                               fadescale=6.5, fadeexp=8.0, **kw)
    assert asked == [False] and out.grad_fn is None
    prims[3].requires_grad_()
    out2 = rc.mvp_raymarch_cuda(rp, rd, s["stepsize"], tmm, *prims, None, device="cpu",
                                fadescale=6.5, fadeexp=8.0, **kw)
    assert asked == [False, True] and torch.equal(out, out2.detach())
    state = out2.grad_fn.saved_tensors[-1]
    assert state.shape[1] == rc.STATE_ROWS and float(state[:, 3].max()) > 0

    # with the state handed over, the gradients still agree with the JAX op
    names, g_j, g_t = _grads_both(s, **kw)
    assert asked[2:] == [True]
    _assert_grads_close(names, g_j, g_t)


@pytest.mark.parametrize("case", ["adversarial_early_out", "plain_rows8", "warp", "bs2",
                                  "bs16"])
def test_accepted_samples_lie_in_own_rows(case):
    """The kernels evaluate a (ray, row, candidate) sample only inside the
    ray's own rows of the candidate: none that the march accepts is outside."""
    s, kw = SCENES[case]()
    gid, scal, t_o, t_d, t_mm, tpl, wrp, dt, fadescale, fadeexp, nbuf = _tiles(s, **kw)
    hit, lo, hi = rc.ray_candidates_plain(scal, t_o, t_d, t_mm, dt, nbuf)
    m = rc._TileMarch(gid, scal, t_o, t_d, t_mm, tpl, wrp, dt, fadescale, fadeexp, nbuf)
    rows = torch.arange(nbuf)
    accepted = 0
    for c in range(gid.shape[1]):
        mask = m.samples(c, 0, nbuf)["mask"]  # [NT, T2, nbuf]
        inside = (hit[..., c, None] & (rows >= lo[..., c, None]) & (rows < hi[..., c, None]))
        assert not bool((mask & ~inside).any()), f"candidate {c}"
        accepted += int(mask.sum())
        # and the tile-coherent range of the plain version covers the own rows
        own = hit[..., c]
        if bool(own.any()):
            for tile in torch.nonzero(own.any(dim=1)).flatten().tolist():
                sel = own[tile]
                assert int(lo[tile, :, c][sel].min()) >= int(m.r0[tile, c])
                assert int(hi[tile, :, c][sel].max()) <= int(m.r1[tile, c])
    assert accepted > 0
    # the ranges are no blanket: they hold fewer rows than the whole march
    assert int((hi - lo)[hit].sum()) < int(hit.sum()) * nbuf
    # a row of margin and the floor / ceil on either side of the accepted rows
    assert int((hi - lo)[hit].sum()) <= accepted + 6 * int(hit.sum())


def test_check_tiles_refusals():
    s, kw = CASES["bs2"]()
    args = _tiles(s, **kw)
    gid, scal, t_o, t_d, t_mm, tpl = args[:6]
    g = torch.zeros(gid.shape[0], 4, t_o.shape[2])
    _, state = rc.march_tiles(*args, with_state=True)
    rc._check_tiles(gid, scal, t_o, t_d, t_mm, tpl, None, state=state, g_tiles=g)

    shifted = torch.empty(tpl.numel() + 1)[1:].view(tpl.shape).copy_(tpl)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        rc._check_tiles(gid, scal, t_o, t_d, t_mm, shifted, None)

    with pytest.raises(ValueError, match="state must be"):
        rc.march_tiles_bwd(gid, scal, t_o, t_d, t_mm, g, *args[5:], state=state[:, :4].contiguous())
    with pytest.raises(ValueError, match="state must be"):
        rc.march_tiles_bwd(gid, scal, t_o, t_d, t_mm, g, *args[5:], state=state[:-1])
    with pytest.raises(ValueError, match="state: need a contiguous float32 tensor on cpu"):
        rc._check_tiles(gid, scal, t_o, t_d, t_mm, tpl, None,
                        state=torch.empty(state.shape, device="meta"))
    with pytest.raises(ValueError, match="state: need a contiguous float32"):
        rc.march_tiles_bwd(gid, scal, t_o, t_d, t_mm, g, *args[5:], state=state.double())


def poison_warped_out_box(args, fill=float("inf")):
    """A copy of ``march_tiles`` arguments (with a warp table) in which the
    box most tiles hold as a candidate is warped wholly out of its template
    (every corner of every sample lies outside) and that template is all
    ``fill`` (inf by default), and a second copy with the template zero there
    instead. Returns (poisoned, zeroed, the box's index)."""
    gid = args[0]
    box = int(torch.mode(gid[gid >= 0].flatten()).values)
    out = []
    for value in (fill, 0.0):
        tpl, wrp = args[5].clone(), args[6].clone()
        wrp[box] = 3.0
        tpl[box] = value
        out.append(args[:5] + (tpl, wrp) + args[7:])
    return out[0], out[1], box


def _assert_unread_box_leaves_the_bound(poisoned, zeroed, state, ref_state, g):
    """The backward's fixed-point bound over the cells the forward read is
    the zero template's: finite, the negative-density bit clear. Returns the
    bounds over the whole template, as they were taken before."""
    gid, scal, t_o, t_d, t_mm, tpl, wrp, dt, fs, fe, nbuf = poisoned
    fixed_point.flag("cpu").zero_()
    scales = rc.fixed_point_scales(g, scal, tpl, wrp, state, dt, fs, fe, nbuf)
    fixed_point.check("cpu")  # raises if the negative-density bit was set
    bounds, alpha_min = rc.fixed_point_bounds(g, scal, tpl, wrp, dt, fs, fe, nbuf, state=state)
    zero, _ = rc.fixed_point_bounds(g, scal, *zeroed[5:7], dt, fs, fe, nbuf, state=ref_state)
    assert bool(torch.isfinite(bounds).all()) and bool(torch.isfinite(scales).all())
    assert torch.equal(bounds, zero) and float(alpha_min) == 0.0
    return rc.fixed_point_bounds(g, scal, tpl, wrp, dt, fs, fe, nbuf)


def test_cell_outside_the_box_is_not_read():
    s, kw = SCENES["bs4_warp"]()
    poisoned, zeroed, box = poison_warped_out_box(_tiles(s, **kw))
    gid, scal, t_o, t_d, t_mm, *rest = poisoned
    m = rc._TileMarch(*poisoned)
    slot = int(torch.nonzero((gid == box).any(dim=0)).flatten()[0])
    assert bool(m.samples(slot, 0, m.nbuf)["mask"][gid[:, slot] == box].any())  # it is sampled
    out, state = rc.march_tiles(*poisoned, with_state=True)
    ref, ref_state = rc.march_tiles(*zeroed, with_state=True)
    assert bool(torch.isfinite(out).all()) and float(out[:, 3].max()) > 0
    assert torch.equal(out, ref) and torch.equal(state, ref_state)
    g = torch.from_numpy(np.random.RandomState(3).randn(*out.shape).astype(np.float32))
    got = rc.march_tiles_bwd(gid, scal, t_o, t_d, t_mm, g, *rest, state=state)
    want = rc.march_tiles_bwd(gid, scal, t_o, t_d, t_mm, g, *zeroed[5:], state=ref_state)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all()) and float(b.abs().max()) > 0
        assert torch.equal(a, b)
    # the kernel's fixed-point bound: over the cells read, finite; over the
    # whole template (as it was taken before), inf, which made the scale NaN
    whole, _ = _assert_unread_box_leaves_the_bound(poisoned, zeroed, state, ref_state, g)
    assert not bool(torch.isfinite(whole).all())


def test_unread_negative_density_leaves_the_flag_clear():
    """A negative density in cells that no sample reads: the bound over the
    cells read is the zero template's and the negative-density bit stays
    clear (over the whole template it was set, and the training loop
    raised); the plain backward equals the zero template's."""
    s, kw = SCENES["bs4_warp"]()
    poisoned, zeroed, _ = poison_warped_out_box(_tiles(s, **kw), fill=-5.0)
    gid, scal, t_o, t_d, t_mm, *rest = poisoned
    out, state = rc.march_tiles(*poisoned, with_state=True)
    ref, ref_state = rc.march_tiles(*zeroed, with_state=True)
    assert torch.equal(out, ref) and torch.equal(state, ref_state)
    g = torch.from_numpy(np.random.RandomState(3).randn(*out.shape).astype(np.float32))
    _, whole_min = _assert_unread_box_leaves_the_bound(poisoned, zeroed, state, ref_state, g)
    assert float(whole_min) < 0
    got = rc.march_tiles_bwd(gid, scal, t_o, t_d, t_mm, g, *rest, state=state)
    want = rc.march_tiles_bwd(gid, scal, t_o, t_d, t_mm, g, *zeroed[5:], state=ref_state)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_a_read_inf_cell_gives_a_non_finite_bound():
    """An inf in cells the samples do read makes the bound of the alpha and
    warp tables, and so their scales, non-finite: the backward then reads
    NaN there, as the reference's own gradient would be."""
    s, kw = SCENES["bs4_warp"]()
    args = _tiles(s, **kw)
    gid, scal, t_o, t_d, t_mm, tpl, wrp, dt, fs, fe, nbuf = args
    tpl = tpl.clone()
    tpl[int(torch.mode(gid.flatten()).values)] = float("inf")
    _, state = rc.march_tiles(gid, scal, t_o, t_d, t_mm, tpl, wrp, dt, fs, fe, nbuf,
                              with_state=True)
    assert float(state[:, 5].max()) == float("inf")
    fixed_point.flag("cpu").zero_()
    scales = rc.fixed_point_scales(torch.ones(t_o.shape[0], 4, t_o.shape[2]), scal, tpl, wrp,
                                   state, dt, fs, fe, nbuf)
    fixed_point.check("cpu")
    assert bool(torch.isnan(scales[3:]).all()) and bool(torch.isfinite(scales[:3]).all())


@pytest.mark.parametrize("case", ["bs2", "bs4_warp", "bs8_saturating", "bs16"])
def test_bounds_over_the_cells_read_hold(case):
    """The backward's bounds taken over the cells the forward read (its
    state) are at most the whole template's and at least the sum of |the
    plain version's gradients| of each channel group."""
    s, kw = SCENES[case]()
    args = _tiles(s, **kw)
    gid, scal, t_o, t_d, t_mm, tpl, wrp, dt, fs, fe, nbuf = args
    _, state = rc.march_tiles_plain(*args, with_state=True)
    g = torch.from_numpy(np.random.RandomState(5).randn(t_o.shape[0], 4, t_o.shape[2])
                         .astype(np.float32))
    d_tpl, d_wrp, _ = rc.march_tiles_bwd_plain(gid, scal, t_o, t_d, t_mm, g, *args[5:],
                                               state=state)
    read, alpha_min = rc.fixed_point_bounds(g, scal, tpl, wrp, dt, fs, fe, nbuf, state=state)
    whole, _ = rc.fixed_point_bounds(g, scal, tpl, wrp, dt, fs, fe, nbuf)
    sums = [float(d_tpl[..., c].abs().sum()) for c in range(4)]
    sums.append(float(d_wrp.abs().sum()) if wrp is not None else 0.0)
    assert float(alpha_min) == 0.0 and bool((read <= whole).all())
    for c, (b, total) in enumerate(zip(read.tolist(), sums)):
        assert b >= total, (c, b, total)
    assert min(sums[:4]) > 0.0
