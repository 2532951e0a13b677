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
  bit, and a state that says what the composite did;
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
  index is clamped to, a non-finite value included.
"""

import numpy as np
import pytest

import torch

from ava256_tpu_torch.data.synthetic import raymarch_scene
from ava256_tpu_torch.ops import raymarch_cuda as rc
from ava256_tpu_torch.ops.math3d import rodrigues

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


def poison_warped_out_box(args):
    """A copy of ``march_tiles`` arguments (with a warp table) in which the
    box most tiles hold as a candidate is warped wholly out of its template
    (every corner of every sample lies outside) and that template is all inf,
    and a second copy with the template zero there instead. Returns
    (poisoned, zeroed, the box's index)."""
    gid = args[0]
    box = int(torch.mode(gid[gid >= 0].flatten()).values)
    out = []
    for fill in (float("inf"), 0.0):
        tpl, wrp = args[5].clone(), args[6].clone()
        wrp[box] = 3.0
        tpl[box] = fill
        out.append(args[:5] + (tpl, wrp) + args[7:])
    return out[0], out[1], box


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
