# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The CUDA raymarch kernels against their plain PyTorch versions, on the card,
and the decode's modules replayed as CUDA graphs against the eager decode.

Imports neither JAX nor the JAX package, so it runs on a machine with only
PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Without a card every test skips. Forward tolerance 1e-5: the kernel runs the
plain version's fp32 operations in the same order (built without FMA
contraction); what remains is ulp-level ``expf`` and division rounding. The
backward kernel sums over rays, rows and tiles as integers at a fixed-point
scale, so two runs give the same bits (held bitwise), and its gradients are
held to the plain version's float sums at max |d| <= BWD_TOL * max |ref| and
cosine > 0.99999; so are the grid-sample kernels' against F.grid_sample. The forward kernel's
second output, the rays' saturation state, is held to the forward tolerance,
and the backward kernel must give the same gradients (to BWD_TOL) whether it
is handed that state or has the wrapper run the forward kernel for it. A
trilinear corner outside the box reads zero in the kernels whatever lies in
the cell its index is clamped to, inf included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ava256_tpu_torch.data.synthetic import raymarch_scene
from ava256_tpu_torch.ops import graphs
from ava256_tpu_torch.ops import raymarch_cuda as rc
from ava256_tpu_torch.ops.math3d import rodrigues
from ava256_tpu_torch.render import BATCH_MODEL_KEYS, decode

from _graph_cases import FRAMES_3, GRAPHED, tensors, warm_scene

pytestmark = pytest.mark.cuda
BWD_TOL = 2e-5
GRAD_NAMES = ("primpos", "primrot", "primscale", "template", "warp")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _args(s, dev):
    t = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in s.items()
         if isinstance(v, np.ndarray)}
    return (t["raypos"], t["raydir"], s["stepsize"], t["tminmax"], t["primpos"],
            rodrigues(t["primrvec"]), t["primscale"], t["template"], t.get("warp"))


@pytest.mark.parametrize("bs,warp,tile,opaque", [
    (8, False, 16, False), (8, True, 8, False), (4, True, 16, False), (2, False, 8, False),
    (8, False, 16, True),  # rays saturate: the windowed early exit
])
def test_kernel_matches_plain(card, bs, warp, tile, opaque):
    s = raymarch_scene(n=2, h=37, w=35, k3=3, bs=bs, warp=warp, seed=bs)
    if opaque:
        s["template"][..., 3] *= 30.0
    mask = torch.from_numpy((np.random.RandomState(0).rand(2, 27) > 0.3).astype(np.float32))
    kw = dict(fadescale=6.5, fadeexp=8.0, tile=tile, max_hit=27, nbuf=64)
    ref = rc.mvp_raymarch_cuda(*_args(s, "cpu"), prim_mask=mask, device="cpu", **kw)
    before = rc.march_tiles_kernel.launches
    out = rc.mvp_raymarch_cuda(*_args(s, card), prim_mask=mask.to(card), device=card, **kw)
    torch.cuda.synchronize()
    assert rc.march_tiles_kernel.launches == before + 1
    assert ref[..., 3].max() > 0.5
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_kernel_rejects_what_it_does_not_take(card):
    s = raymarch_scene(n=1, h=16, w=16, k3=2, bs=8)
    args = list(_args(s, card))
    with pytest.raises(ValueError, match="multiple of 32"):
        rc.mvp_raymarch_cuda(*args, tile=4, device=card)
    args[7] = args[7].double()
    with pytest.raises(ValueError, match="float32"):
        rc.mvp_raymarch_cuda(*args, tile=8, device=card)


def _op_grads(s, dev, mask, g, kw):
    """Gradients of sum(op * g) in primpos, primrot, primscale, template, warp."""
    args = list(_args(s, dev))
    leaves = [a.detach().requires_grad_() if a is not None else None for a in args[4:9]]
    out = rc.mvp_raymarch_cuda(*args[:4], *leaves, prim_mask=mask.to(dev), device=dev, **kw)
    (out * g.to(dev)).sum().backward()
    return out.detach(), [None if x is None else x.grad for x in leaves]


@pytest.mark.parametrize("bs,warp,tile,opaque", [
    (8, False, 16, False), (8, True, 8, False), (4, True, 16, False), (2, False, 8, False),
    (16, False, 8, False),
    (8, False, 16, True),  # rays saturate: cotangents end at the saturation row
])
def test_bwd_kernel_matches_plain(card, bs, warp, tile, opaque):
    s = raymarch_scene(n=2, h=37, w=35, k3=3, bs=bs, warp=warp, seed=bs)
    if opaque:
        s["template"][..., 3] *= 30.0
    mask = torch.from_numpy((np.random.RandomState(0).rand(2, 27) > 0.3).astype(np.float32))
    g = torch.from_numpy(np.random.RandomState(1).randn(2, 37, 35, 4).astype(np.float32))
    kw = dict(fadescale=6.5, fadeexp=8.0, tile=tile, max_hit=27, nbuf=64)
    _, ref = _op_grads(s, "cpu", mask, g, kw)
    before = rc.march_tiles_bwd_kernel.launches
    _, got = _op_grads(s, card, mask, g, kw)
    torch.cuda.synchronize()
    assert rc.march_tiles_bwd_kernel.launches == before + 1
    for name, a, b in zip(GRAD_NAMES, got, ref):
        if b is None:
            assert a is None and name == "warp"
            continue
        a, b = a.cpu().double(), b.double()
        assert torch.isfinite(a).all() and float(b.abs().max()) > 0, name
        err = float((a - b).abs().max() / b.abs().max())
        cos = float((a * b).sum() / torch.sqrt((a * a).sum() * (b * b).sum()))
        print(f"bs={bs} warp={warp} {name}: max|d|/max|ref| {err:.3g} cos {cos:.8f}")
        assert err <= BWD_TOL and cos > 0.99999, (name, err, cos)


def scene_262k():
    """K = 262,144 primitives of 2^3 (configs/config-synthetic-262k.yaml's
    count and size) on a 64^3 grid, boxes about 10 grid steps wide, marched
    in 64 rows over the grid's depth, dense enough that rays saturate."""
    s = raymarch_scene(n=1, h=37, w=35, k3=64, bs=2, seed=5)
    s["primscale"] = np.full_like(s["primscale"], 10.0)
    s["template"][..., 3] *= 20.0
    s["stepsize"] = 0.0125
    tmm = s["tminmax"]
    tmm[..., 0] = 3.6 + 0.01 * tmm[..., 0]
    tmm[..., 1] = 4.4
    return s


def test_kernels_at_262144_primitives_of_2(card):
    """Both kernels behind the op at the 262k configuration's primitive
    count and size, culled in two stages (K >= 65,536), against the plain
    versions; the backward is handed the forward's state."""
    s = scene_262k()
    K = s["primpos"].shape[1]
    assert K == 262_144 and s["template"].shape[2] == 2
    mask = torch.ones((1, K))
    g = torch.from_numpy(np.random.RandomState(2).randn(1, 37, 35, 4).astype(np.float32))
    kw = dict(fadescale=6.5, fadeexp=8.0, tile=16, max_hit=64, nbuf=64)
    out_ref, ref = _op_grads(s, "cpu", mask, g, kw)
    before = (rc.march_tiles_kernel.launches, rc.march_tiles_bwd_kernel.launches_with_state)
    out, got = _op_grads(s, card, mask, g, kw)
    torch.cuda.synchronize()
    assert (rc.march_tiles_kernel.launches, rc.march_tiles_bwd_kernel.launches_with_state) == \
        (before[0] + 1, before[1] + 1)
    assert float(out_ref[..., 3].max()) > 0.1
    np.testing.assert_allclose(out.cpu().numpy(), out_ref.numpy(), rtol=1e-5, atol=1e-5)
    for name, a, b in zip(GRAD_NAMES[:4], got, ref):
        a, b = a.cpu().double(), b.double()
        assert torch.isfinite(a).all() and float(b.abs().max()) > 0, name
        err = float((a - b).abs().max() / b.abs().max())
        cos = float((a * b).sum() / torch.sqrt((a * a).sum() * (b * b).sum()))
        assert err <= BWD_TOL and cos > 0.99999, (name, err, cos)


def _tile_args(s, dev, tile, max_hit, nbuf=64, opaque=False):
    """The arguments of ``rc.march_tiles`` for a scene, culled as the op culls."""
    t = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in s.items()
         if isinstance(v, np.ndarray)}
    if opaque:
        t["template"][..., 3] *= 30.0
    dt = float(s["stepsize"])
    tmm = t["tminmax"]
    tmm = torch.stack([tmm[..., 0], torch.minimum(tmm[..., 1], tmm[..., 0] + nbuf * dt)], -1)
    n, K = t["primpos"].shape[:2]
    bs = t["template"].shape[2]
    t_o, t_d, t_mm, gid, valid, _, _ = rc.tile_and_cull(
        t["raypos"], t["raydir"], tmm, t["primpos"], t["primscale"],
        torch.ones((n, K), device=dev), tile, max_hit, dt)
    scal = rc.candidate_affines(t["primpos"], rodrigues(t["primrvec"]), t["primscale"], gid,
                                valid)
    wrp = t["warp"].reshape(n * K, bs, bs, bs, 3).contiguous() if "warp" in t else None
    return (gid.to(torch.int32).contiguous(), scal, t_o, t_d, t_mm,
            t["template"].reshape(n * K, bs, bs, bs, 4).contiguous(), wrp, dt, 6.5, 8.0, nbuf)


def _assert_grads(got, ref, what):
    for name, a, b in zip(("d_template", "d_warp", "d_affine"), got, ref):
        if b is None:
            assert a is None
            continue
        a, b = a.cpu().double(), b.cpu().double()
        assert torch.isfinite(a).all() and float(b.abs().max()) > 0, (what, name)
        err = float((a - b).abs().max() / b.abs().max())
        cos = float((a * b).sum() / torch.sqrt((a * a).sum() * (b * b).sum()))
        assert err <= BWD_TOL and cos > 0.99999, (what, name, err, cos)


@pytest.mark.parametrize("bs,warp,tile,opaque", [
    (8, False, 16, True), (8, True, 8, False), (4, False, 16, False), (2, False, 8, True),
])
def test_state_and_backward_with_state(card, bs, warp, tile, opaque):
    s = raymarch_scene(n=2, h=37, w=35, k3=3, bs=bs, warp=warp, seed=bs)
    cpu = _tile_args(s, "cpu", tile, 27, opaque=opaque)
    dev = _tile_args(s, card, tile, 27, opaque=opaque)
    ref_out, ref_state = rc.march_tiles_plain(*cpu, with_state=True)
    before = rc.march_tiles_kernel.launches
    out, state = rc.march_tiles(*dev, with_state=True)
    assert rc.march_tiles_kernel.launches == before + 1
    assert torch.equal(rc.march_tiles(*dev), out)  # the state output leaves RGBA alone
    np.testing.assert_allclose(out.cpu().numpy(), ref_out.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.cpu().numpy(), ref_state.numpy(), rtol=1e-5, atol=1e-5)
    if opaque:
        assert float(ref_state[:, 3].max()) > 0  # some ray saturates

    g = torch.from_numpy(np.random.RandomState(1).randn(*ref_out.shape).astype(np.float32))
    gid, scal, t_o, t_d, t_mm, *rest = dev
    counts = (rc.march_tiles_bwd_kernel.launches, rc.march_tiles_bwd_kernel.launches_with_state,
              rc.march_tiles_kernel.launches)
    with_state = rc.march_tiles_bwd(gid, scal, t_o, t_d, t_mm, g.to(card), *rest, state=state)
    assert rc.march_tiles_kernel.launches == counts[2]  # no second forward march
    without = rc.march_tiles_bwd(gid, scal, t_o, t_d, t_mm, g.to(card), *rest)
    torch.cuda.synchronize()
    assert rc.march_tiles_bwd_kernel.launches == counts[0] + 2
    assert rc.march_tiles_bwd_kernel.launches_with_state == counts[1] + 1
    assert rc.march_tiles_kernel.launches == counts[2] + 1  # the wrapper ran it for the state
    gid, scal, t_o, t_d, t_mm, *rest = cpu
    plain = rc.march_tiles_bwd_plain(gid, scal, t_o, t_d, t_mm, g, *rest, state=ref_state)
    _assert_grads(with_state, plain, "with state")
    _assert_grads(without, plain, "without state")
    with pytest.raises(ValueError, match="state must be"):
        rc.march_tiles_bwd(*dev[:5], g.to(card), *dev[5:], state=state[:-1].contiguous())
    with pytest.raises(ValueError, match="state: need a contiguous float32"):
        rc.march_tiles_bwd(*dev[:5], g.to(card), *dev[5:], state=state.cpu())


@pytest.mark.parametrize("max_hit,k3,tile", [(128, 6, 16), (40, 4, 8), (1, 3, 8)])
def test_kernels_take_any_max_hit(card, max_hit, k3, tile):
    """max_hit 128 (the largest the repo's configurations use), one that is
    no multiple of 32, and a single candidate."""
    s = raymarch_scene(n=1, h=33, w=31, k3=k3, bs=4, warp=False, seed=k3)
    mask = torch.ones(1, k3 ** 3)
    g = torch.from_numpy(np.random.RandomState(1).randn(1, 33, 31, 4).astype(np.float32))
    kw = dict(fadescale=6.5, fadeexp=8.0, tile=tile, max_hit=max_hit, nbuf=64)
    ref_out, ref = _op_grads(s, "cpu", mask, g, kw)
    out, got = _op_grads(s, card, mask, g, kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref_out.numpy(), rtol=1e-5, atol=1e-5)
    for name, a, b in zip(GRAD_NAMES, got, ref):
        if b is None:
            continue
        a, b = a.cpu().double(), b.double()
        assert float(b.abs().max()) > 0, name
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= BWD_TOL, (name, err)


def test_cell_outside_the_box_is_not_read(card):
    """A box warped wholly out of its template, the template all inf: every
    corner of its samples lies outside and reads zero, so the kernels give what
    they give with a zero template there, and what the plain versions give."""
    s = raymarch_scene(n=2, h=37, w=35, k3=3, bs=4, warp=True, seed=4)
    args = _tile_args(s, card, 8, 27)
    box = int(torch.mode(args[0].flatten()).values)
    outs = []
    for fill in (float("inf"), 0.0):
        gid, scal, t_o, t_d, t_mm, tpl, wrp, *rest = args
        tpl, wrp = tpl.clone(), wrp.clone()
        tpl[box], wrp[box] = fill, 3.0
        out, state = rc.march_tiles(gid, scal, t_o, t_d, t_mm, tpl, wrp, *rest, with_state=True)
        g = torch.from_numpy(np.random.RandomState(1).randn(*out.shape).astype(np.float32))
        grads = rc.march_tiles_bwd(gid, scal, t_o, t_d, t_mm, g.to(card), tpl, wrp, *rest,
                                   state=state)
        outs.append((out, state, grads, tpl, wrp))
    (out, state, grads, tpl, wrp), (out0, state0, grads0, _, _) = outs
    assert bool(torch.isfinite(out).all()) and float(out[:, 3].max()) > 0.5
    assert torch.equal(out, out0) and torch.equal(state, state0)
    _assert_grads(grads, grads0, "inf against zero template")
    cpu = tuple(x.cpu() if torch.is_tensor(x) else x for x in
                (*args[:5], tpl, wrp, *args[7:]))
    ref, ref_state = rc.march_tiles_plain(*cpu, with_state=True)
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.cpu().numpy(), ref_state.numpy(), rtol=1e-5, atol=1e-5)
    plain = rc.march_tiles_bwd_plain(*cpu[:5], g, *cpu[5:], state=ref_state)
    _assert_grads(grads, plain, "inf template against plain")


# ---------------------------------------------------------------------------
# the entry points' data path and metrics on the card
# ---------------------------------------------------------------------------


def test_device_prefetch_side_stream_equals_plain_copy(card):
    """Batches uploaded from pinned memory on a side stream in the feeder
    thread are bit-equal to a plain ``.to(device)``, also while the consumer's
    stream is busy, and an abandoned prefetch stops its threads."""
    import threading
    import time

    from ava256_tpu_torch.data import ShardedLoader, SyntheticDataset, device_prefetch
    from ava256_tpu_torch.data.loader import Upload, Uploader

    ds = SyntheticDataset(nident=2, ncams=3, nframes=4, height=64, width=48, texsize=64)
    loader = ShardedLoader(ds, batch_size=3, num_workers=2, shuffle=False)
    up = Uploader(card)
    assert isinstance(up({"x": np.zeros(3, np.float32)}), Upload)
    busy = torch.randn(2048, 2048, device=card)
    got = []
    for batch in device_prefetch(loader, up, depth=2):
        busy = busy @ busy / 2048.0  # keep the consumer's stream working
        got.append({k: v.clone() for k, v in batch.items()})
    ref = [{k: torch.as_tensor(np.asarray(v)).to(card) for k, v in b.items()} for b in loader]
    assert len(got) == len(ref) == len(loader)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            assert torch.equal(g[k], r[k]), k
    before = set(threading.enumerate())
    gen = device_prefetch(loader, up, depth=1)
    first = next(gen)
    assert torch.equal(first["image"], ref[0]["image"])
    gen.close()
    started = [t for t in threading.enumerate() if t not in before]
    deadline = time.time() + 5
    while any(t.is_alive() for t in started) and time.time() < deadline:
        time.sleep(0.02)
    assert not any(t.is_alive() for t in started)
    torch.cuda.synchronize()


def test_metrics_on_the_card_equal_the_cpu(card):
    """ssim (fp64 blur) within 1e-5 and lpips (fp32, TF32 off) within 1e-4
    relative of the same functions on the CPU, at the flagship's image size."""
    from ava256_tpu_torch.train import metrics

    rng = np.random.RandomState(0)
    x = (rng.rand(2, 512, 334, 3) * 255).astype(np.float32)
    y = np.clip(x + rng.randn(*x.shape) * 20, 0, 255).astype(np.float32)
    cpu = [torch.from_numpy(a) for a in (x, y)]
    dev = [t.to(card) for t in cpu]
    for fn, tol in ((metrics.ssim, 1e-5), (metrics.lpips, 1e-4), (metrics.psnr, 1e-6)):
        a, b = float(fn(*dev)), float(fn(*cpu))
        assert abs(a - b) <= tol * abs(b), (fn.__name__, a, b)


def test_config4_march_on_captured_batches(card, tmp_path):
    """Config-4's march on a batch of captured items: 4 items of 4 written
    captures at 512x333 (4096x2668 at downsample 8), 16,384 primitives of
    8^3 from the decoders (random weights), tile 16, max_hit 128; the kernels
    against their plain versions on every 16th tile, forward and its state at
    1e-5, backward at BWD_TOL."""
    from ava256_tpu_torch.data import (
        MultiCaptureDataset, SyntheticDataset, none_collate, train_csv_loader, write_capture)
    from ava256_tpu_torch.data.loader import Uploader
    from ava256_tpu_torch.data.synthetic import synthetic_uvdata
    from ava256_tpu_torch.factory import get_autoencoder
    from ava256_tpu_torch.render import BATCH_MODEL_KEYS
    from ava256_tpu_torch.train.loop import to_model_batch

    syn = SyntheticDataset(nident=4, ncams=4, nframes=1, height=512, width=334, texsize=1024)
    csv = write_capture(tmp_path, syn, downsample=8, image_hw=(512, 334))
    ds = MultiCaptureDataset(*train_csv_loader(tmp_path, csv, 4), downsample=8)
    assert ds.get_img_size() == (512, 333)
    items = [ds[i] for i in (0, 5, 10, 15)]  # one camera of each identity
    assert all(x is not None for x in items)
    b = Uploader(card).now(to_model_batch(none_collate(items)))
    model = get_autoencoder(synthetic_uvdata(1024), ds.vertmean, ds.vertstd, ncams=4, nident=4,
                            nprims=16384, primsize=(8, 8, 8),
                            raymarch_options={"tile": 16, "max_hit": 128}, device=card, seed=0)
    kw = dict(target_neut_avgtex=b["neut_avgtex"], target_neut_verts=b["neut_verts"],
              idindex=b["idindex"], camindex=b["camindex"], **{k: b[k] for k in BATCH_MODEL_KEYS})
    with torch.inference_mode():
        model(running_avg_scale=True, generator=torch.Generator(device=card).manual_seed(1), **kw)
        mi = model(deterministic=True, output_set=frozenset({"march_inputs"}), **kw)[
            "march_inputs"]
        dt = float(mi["stepsize"])
        nbuf = rc.default_nbuf(dt)
        n, K = mi["primpos"].shape[:2]
        tmm = mi["tminmax"]
        tmm = torch.stack([tmm[..., 0], torch.minimum(tmm[..., 1], tmm[..., 0] + nbuf * dt)], -1)
        t_o, t_d, t_mm, gid, valid, _, _ = rc.tile_and_cull(
            mi["raypos"], mi["raydir"], tmm, mi["primpos"], mi["primscale"],
            torch.ones((n, K), device=card), 16, 128, dt)
        scal = rc.candidate_affines(mi["primpos"], mi["primrot"], mi["primscale"], gid, valid)
    hits = valid.sum(1)
    print(f"tiles {gid.shape[0]}, candidates per tile: max {int(hits.max())}, "
          f"mean {float(hits.float().mean()):.1f}, tiles over 64: {int((hits > 64).sum())}")
    assert gid.shape == (4 * 32 * 21, 128) and int(hits.max()) > 0
    sel = slice(0, gid.shape[0], 16)
    warp = mi.get("warp")
    args = (gid[sel].to(torch.int32).contiguous(), scal[sel].contiguous(), t_o[sel].contiguous(),
            t_d[sel].contiguous(), t_mm[sel].contiguous(),
            mi["template"].reshape(n * K, 8, 8, 8, 4).contiguous(),
            None if warp is None else warp.reshape(n * K, 8, 8, 8, 3).contiguous(),
            dt, 8.0, 8.0, nbuf)
    before = (rc.march_tiles_kernel.launches, rc.march_tiles_bwd_kernel.launches)
    out, state = rc.march_tiles(*args, with_state=True)
    ref, ref_state = rc.march_tiles_plain(*args, with_state=True)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.cpu().numpy(), ref_state.cpu().numpy(), rtol=1e-5,
                               atol=1e-5)
    assert float(ref[:, 3].max()) > 0.5  # the head is in the selected tiles
    g = torch.from_numpy(np.random.RandomState(2).randn(*out.shape).astype(np.float32)).to(card)
    grads = rc.march_tiles_bwd(*args[:5], g, *args[5:], state=state)
    plain = rc.march_tiles_bwd_plain(*args[:5], g, *args[5:], state=ref_state)
    torch.cuda.synchronize()
    assert (rc.march_tiles_kernel.launches, rc.march_tiles_bwd_kernel.launches) == \
        (before[0] + 1, before[1] + 1)
    _assert_grads(grads, plain, "config-4 on captures")


def test_compacted_marcher_matches_the_kernels(card):
    """The compacted marcher (``raymarch_xla``, plain PyTorch on the card)
    against the CUDA kernels on the same samples, by
    ``kbench.compare_with_kernels``: the alpha of every ray and the images of
    the rays that saturate in neither (the two composite a saturating step
    by different rules) at 1e-4, the gradients under a cotangent on those
    rays at cosine > 0.9999 and max |d| <= 1e-3 max |ref|."""
    from ava256_tpu_torch import kbench

    s = raymarch_scene(n=2, h=37, w=35, k3=3, bs=8, warp=True, seed=8)
    s["template"][..., 3] *= 1.6  # about a third of the rays saturate
    s["primrot"] = rodrigues(torch.from_numpy(s["primrvec"])).numpy()
    before = (rc.march_tiles_kernel.launches, rc.march_tiles_bwd_kernel.launches)
    rep = kbench.compare_with_kernels(kbench.scene_tensors(s, card), s["stepsize"], tile=16,
                                      max_hit=27, max_samples=512, chunk_tiles=8, fadescale=6.5)
    assert (rc.march_tiles_kernel.launches, rc.march_tiles_bwd_kernel.launches) == (
        before[0] + 1, before[1] + 1)
    assert rep["truncated_tiles"] == 0 and rep["overflow_rays"] == 0, rep
    assert 0.3 < rep["free_share"] < 0.95, rep
    assert rep["alpha_beyond_1e-4"] == 0 and rep["image_beyond_1e-4_free"] == 0, rep
    for k, v in rep.items():
        if k.endswith("_cos"):
            assert v > 0.9999, (k, rep)
        if k.startswith("grad_") and k.endswith("_rel_err"):
            assert v <= 1e-3, (k, rep)


@pytest.mark.parametrize("bs,warp,tile,opaque", [
    (8, False, 16, True), (8, True, 8, False), (2, False, 8, False), (16, True, 16, False),
])
def test_bwd_kernel_twice_is_bitwise_equal(card, bs, warp, tile, opaque):
    """The backward kernel's sums are integer sums at a fixed-point scale:
    two runs on the same inputs give the same bits, gradients of the
    template, the warp and the affines alike; no addend is lost."""
    from ava256_tpu_torch.ops import fixed_point

    s = raymarch_scene(n=2, h=37, w=35, k3=3, bs=bs, warp=warp, seed=bs)
    dev = _tile_args(s, card, tile, 27, opaque=opaque)
    _, state = rc.march_tiles(*dev, with_state=True)
    gid, scal, t_o, t_d, t_mm, *rest = dev
    g = torch.randn((gid.shape[0], 4, t_o.shape[2]), device=card,
                    generator=torch.Generator(device=card).manual_seed(4))
    runs = [rc.march_tiles_bwd(gid, scal, t_o, t_d, t_mm, g, *rest, state=state)
            for _ in range(3)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert (a is None and b is None) or torch.equal(a, b)
    fixed_point.check(card)


def test_bwd_kernel_flag_raises(card):
    """A negative density, the premise of the fixed-point bound, sets the
    device flag, and the check the training loop makes with each step's
    loss raises on it: never zeroed or hidden."""
    from ava256_tpu_torch.ops import fixed_point

    s = raymarch_scene(n=2, h=37, w=35, k3=3, bs=8, warp=False, seed=8)
    gid, scal, t_o, t_d, t_mm, tpl, *rest = _tile_args(s, card, 16, 27)
    tpl = tpl.clone()
    tpl[0, 0, 0, 0, 3] = -1.0
    g = torch.ones((gid.shape[0], 4, t_o.shape[2]), device=card)
    fixed_point.check(card)
    rc.march_tiles_bwd_kernel(gid, scal, t_o, t_d, t_mm, g, tpl, *rest)
    with pytest.raises(fixed_point.FixedPointOverflow, match="negative"):
        fixed_point.check(card)
    fixed_point.check(card)  # the flag was cleared


@pytest.mark.parametrize("shape", [
    ((4, 64, 64, 16), (4, 64, 64, 2)),  # a pyramid level on the warp grid
    ((4, 32, 32, 3), (4, 7306, 1, 2)),  # the vertex sampling
    ((2, 9, 11, 300), (2, 6, 7, 2)),    # more channels than lanes per pixel
])
def test_grid_sample_kernel_matches_plain_and_reruns_bitwise(card, shape):
    from ava256_tpu_torch.ops import fixed_point
    from ava256_tpu_torch.ops import grid_sample as gs

    gen = torch.Generator(device=card).manual_seed(6)
    img = torch.randn(shape[0], device=card, generator=gen)
    grid = torch.rand(shape[1], device=card, generator=gen) * 2.6 - 1.3
    gout = torch.randn(shape[0][:1] + shape[1][1:3] + shape[0][3:], device=card, generator=gen)
    k = gs.grid_sample_kernels
    before = (k.launches, k.bwd_launches)
    out = gs.GridSample.apply(img, grid, False)
    assert (k.launches, k.bwd_launches) == (before[0] + 1, before[1])
    runs = [k.backward(img, grid, gout) for _ in range(2)]
    assert torch.equal(out, k.forward(img, grid))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)  # F.grid_sample's backward, the plain version
    try:
        ref = gs.grid_sample_plain(img, grid)
        ref_img, ref_grid = gs.grid_sample_bwd_plain(img, grid, gout)
    finally:
        torch.use_deterministic_algorithms(was)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=1e-5, atol=1e-5)
    for name, a, b in (("d_img", runs[0][0], ref_img), ("d_grid", runs[0][1], ref_grid)):
        a, b = a.cpu().double(), b.cpu().double()
        err = float((a - b).abs().max() / b.abs().max())
        cos = float((a * b).sum() / torch.sqrt((a * a).sum() * (b * b).sum()))
        assert err <= BWD_TOL and cos > 0.99999, (name, err, cos)
    fixed_point.check(card)


def _gs_case(card, n, h, w, c, layout, shared, jitter, seed):
    """img [n, h, w, c] (an NHWC view of channels-first planes, or packed
    NHWC: channels-last, as the model's convolutions give most of its
    levels), a grid on the pixel centres moved
    by up to ``jitter`` pixels (expanded over the batch when ``shared``), and
    gout in the image's layout."""
    gen = torch.Generator(device=card).manual_seed(seed)

    def nhwc(*shape):
        if layout == "planes":
            return torch.randn((shape[0], shape[3], shape[1], shape[2]), device=card,
                               generator=gen).permute(0, 2, 3, 1)
        return torch.randn(shape, device=card, generator=gen)

    ys = (2.0 * torch.arange(h, device=card) + 1.0) / h - 1.0
    xs = (2.0 * torch.arange(w, device=card) + 1.0) / w - 1.0
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([xg, yg], -1)[None].repeat(1 if shared else n, 1, 1, 1)
    scale = torch.tensor([2.0 / w, 2.0 / h], device=card)
    grid = grid + jitter * scale * (torch.rand(grid.shape, device=card, generator=gen) * 2 - 1)
    if shared:
        grid = grid.expand(n, -1, -1, -1)
    return nhwc(n, h, w, c), grid, nhwc(n, h, w, c)


def _gs_escapes(gs, img, grid):
    n, h, w, c = img.shape
    p = gs.owner_plan(n, h, w, c, grid.stride(0) == 0 or n == 1)
    return gs.escape_count_plain(grid, h, w, p["tw"], p["th"])


def _gs_refs(gs, img, grid, gout):
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)  # F.grid_sample's backward, the plain version
    try:
        return (gs.grid_sample_plain(img, grid),) + gs.grid_sample_bwd_plain(img, grid, gout)
    finally:
        torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("layout", ["planes", "packed"])
@pytest.mark.parametrize("c", [1, 3, 16, 64, 256])
def test_grid_sample_image_gradient_is_the_plain_fixed_point_sum(card, c, layout, shared):
    """The redesigned kernels on a warp level (an output of the image's
    size, large enough for the owner route): the image gradient equals
    grid_sample_bwd_fixed_plain bit for bit at the scale the kernel used;
    the owner and scatter routes, each forced, with the grid gradient fused
    or not, give the same bits; a rerun too; the device escape count equals
    escape_count_plain (0: the owner route); outputs and gradients within
    the limits of F.grid_sample."""
    from ava256_tpu_torch.ops import fixed_point
    from ava256_tpu_torch.ops import grid_sample as gs

    h = w = 64
    img, grid, gout = _gs_case(card, 3, h, w, c, layout, shared, 1.5, seed=c)
    k = gs.grid_sample_kernels
    out = k.forward(img, grid)
    owner = k.owner_launches
    gimg, ggrid = k.backward(img, grid, gout)
    scale, count = k.last_scale.clone(), int(k.last_count)
    assert k.owner_launches == owner + 1
    assert count == _gs_escapes(gs, img, grid) == 0
    assert gs.channels_first(out) == gs.channels_first(gimg) == (layout == "planes" or c == 1)
    assert torch.equal(gimg, gs.grid_sample_bwd_fixed_plain(img, grid, gout, scale))
    for route in ("owner", "scatter"):
        for fuse in (True, False):
            gi, gg = k.backward(img, grid, gout, route=route, fuse_grid=fuse)
            assert torch.equal(gi, gimg), (route, fuse)
            assert torch.equal(gg, ggrid) or not fuse or route == "scatter"
    again = k.backward(img, grid, gout)
    assert torch.equal(again[0], gimg) and torch.equal(again[1], ggrid)
    assert torch.equal(k.forward(img, grid), out)
    ref, ref_img, ref_grid = _gs_refs(gs, img, grid, gout)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=1e-5, atol=1e-5)
    for name, a, b in (("d_img", gimg, ref_img), ("d_grid", ggrid, ref_grid)):
        a, b = a.cpu().double(), b.cpu().double()
        err = float((a - b).abs().max() / b.abs().max())
        cos = float((a * b).sum() / torch.sqrt((a * a).sum() * (b * b).sum()))
        assert err <= BWD_TOL and cos > 0.99999, (name, err, cos)
    fixed_point.check(card)


def test_grid_sample_displaced_warp_takes_the_scatter_route(card):
    """A warp moved past the owner route's window: the device count is the
    plain count (not 0), the owner kernel stands down, the predicated
    scatter route behind it computes the image gradient, bit for bit the
    plain fixed-point sum, and the fallback is counted."""
    from ava256_tpu_torch.ops import grid_sample as gs

    img, grid, gout = _gs_case(card, 2, 64, 64, 16, "planes", True, 0.5, seed=3)
    far = grid + 2.0 * (gs.OWNER_RADIUS + 3) / 64
    k = gs.grid_sample_kernels
    before = k.fallbacks()
    gimg, _ = k.backward(img, far, gout)
    assert int(k.last_count) == _gs_escapes(gs, img, far) > 0
    assert torch.equal(gimg, gs.grid_sample_bwd_fixed_plain(img, far, gout, k.last_scale))
    assert k.fallbacks() == before + 1


def test_grid_sample_backward_launches(card):
    """A warp level's backward on the owner route launches five kernels
    (prep, owner, and the predicated zero, scatter and conversion); a warp
    level below OWNER_MIN_PIXELS and the vertex sampling take the scatter
    route, four each; the model's layouts go in without a copy (the
    forward's output and the image gradient are channels-first like the
    image)."""
    from ava256_tpu_torch.ops import grid_sample as gs

    k = gs.grid_sample_kernels
    img, grid, gout = _gs_case(card, 4, 64, 64, 16, "planes", True, 0.5, seed=4)
    before = (k.bwd_launches, k.bwd_kernels, k.owner_launches, k.scatter_launches)
    leaf = img.detach().requires_grad_()
    out = gs.grid_sample_2d(leaf, grid)
    out.backward(gout)
    assert gs.channels_first(leaf.grad)
    small = _gs_case(card, 4, 16, 16, 16, "planes", True, 0.5, seed=4)
    k.backward(*small)
    geo = torch.randn((4, 3, 32, 32), device=card).permute(0, 2, 3, 1)
    coords = (torch.rand((1, 50, 1, 2), device=card) * 2 - 1).expand(4, -1, -1, -1)
    k.backward(geo, coords, torch.randn((4, 50, 1, 3), device=card))
    after = (k.bwd_launches, k.bwd_kernels, k.owner_launches, k.scatter_launches)
    assert tuple(b - a for a, b in zip(before, after)) == (3, 13, 1, 2)


def test_grid_sample_nonfinite_gout_reads_nan(card):
    """An inf in gout makes the bound, and so the scale, not finite: every
    addend is skipped and the image gradient reads NaN, as a float sum
    would; no flag is set (a pixel's weights sum to 1, so a finite scale can
    never push an addend out of range: the flag is the march's, held by
    test_bwd_kernel_flag_raises)."""
    from ava256_tpu_torch.ops import fixed_point
    from ava256_tpu_torch.ops import grid_sample as gs

    img, grid, gout = _gs_case(card, 2, 24, 24, 3, "planes", True, 0.5, seed=5)
    gout = gout.clone()
    gout[0, 3, 4, 1] = float("inf")
    gimg, _ = gs.grid_sample_kernels.backward(img, grid, gout)
    assert bool(torch.isnan(gimg).all())
    fixed_point.check(card)


# --- the decode's three modules replayed as CUDA graphs (ops/graphs.py) ------

# a small model: the march kernels' buffer a multiple of their warp
SMALL = dict(batch=1, height=32, width=32, nprims=256, texsize=64, primsize=16,
             raymarch_options={"tile": 8, "max_hit": 16, "nbuf": 64, "dt": 16.0})


def _counts(cache):
    return dataclasses.astuple(cache.counts)


def _graph_scene(card, **kw):
    """``warm_scene`` on the card, each graphed module with a new cache (its
    counts start at 0)."""
    scene = warm_scene(card, **kw)
    for name in GRAPHED:
        getattr(scene[0], name).graphs = graphs.GraphCache()
    return scene


def _model_args(mb, tex, verts):
    return dict(target_neut_avgtex=tex, target_neut_verts=verts, idindex=mb["idindex"],
                camindex=mb["camindex"], deterministic=True,
                **{k: mb[k] for k in BATCH_MODEL_KEYS})


def _eager(model, mb, tex, verts):
    """The decode without graphs: grad mode off, but not inference mode."""
    with torch.no_grad():
        return model(**_model_args(mb, tex, verts))["irgbrec"]


def test_graphed_decode_is_eager_bitwise(card):
    model, mb, tex, verts = _graph_scene(card, **SMALL)
    targets = ((mb["neut_avgtex"], mb["neut_verts"]), (tex, verts))
    want = [_eager(model, mb, *t) for t in targets]
    got = [decode(model, mb, *t) for _ in range(3) for t in targets]
    torch.cuda.synchronize()
    for name in GRAPHED:
        assert _counts(getattr(model, name).graphs)[:2] == FRAMES_3[name], name
    assert float(want[0].abs().sum()) > 0
    for i, image in enumerate(got):
        assert torch.equal(image, want[i % 2]), i


def test_graphed_decode_outputs_survive_the_next_decode(card):
    model, mb, tex, verts = _graph_scene(card, **SMALL)
    for _ in range(2):
        decode(model, mb, mb["neut_avgtex"], mb["neut_verts"])
    with torch.inference_mode():
        first = model(**_model_args(mb, mb["neut_avgtex"], mb["neut_verts"]),
                      output_set=frozenset({"idcond"}))
        kept = {k: [t.clone() for t in tensors(first[k])]
                for k in ("irgbrec", "verts", "id_cond")}
        model(**_model_args(mb, tex, verts), output_set=frozenset({"idcond"}))
        model(**_model_args(mb, tex, verts), output_set=frozenset({"idcond"}))
    torch.cuda.synchronize()
    assert {name: _counts(getattr(model, name).graphs)[:2] for name in GRAPHED} == {
        "identity_encoder": (2, 3), "expression_encoder": (1, 4), "decoder_assembler": (2, 3)}
    for k, saved in kept.items():
        assert all(torch.equal(a, b) for a, b in zip(tensors(first[k]), saved)), k


def test_graphed_decode_reads_weights_loaded_after_capture(card):
    model, mb, tex, verts = _graph_scene(card, **SMALL)
    for _ in range(2):
        decode(model, mb, tex, verts)
    before = decode(model, mb, tex, verts)
    state = {k: v * 1.01 if v.is_floating_point() else v for k, v in model.state_dict().items()}
    model.load_state_dict(state)
    got = decode(model, mb, tex, verts)
    want = _eager(model, mb, tex, verts)
    for name in GRAPHED:
        assert _counts(getattr(model, name).graphs)[:2] == (1, 3), name
    assert torch.equal(got, want)
    assert not torch.equal(got, before)


def test_graphed_decode_captures_a_new_input_shape_anew(card):
    model, mb, tex, verts = _graph_scene(card, **dict(SMALL, batch=2))
    one = {k: v[:1] if torch.is_tensor(v) else v for k, v in mb.items()}
    for batch in (mb, one):
        t = (batch["neut_avgtex"], batch["neut_verts"])
        got = [decode(model, batch, *t) for _ in range(3)]
        want = _eager(model, batch, *t)
        assert all(torch.equal(g, want) for g in got)
    for name in GRAPHED:
        assert _counts(getattr(model, name).graphs) == (2, 4, 4, 0), name


def test_graphed_decode_counts_the_launches_it_replays(card):
    """The grid-sample kernels' launch count: a replay adds what an eager
    decode launches; a capture adds its warm-up's launches, and not those it
    recorded. (The eager decode, outside inference mode, is each cache's
    first eager call.)"""
    from ava256_tpu_torch.ops import grid_sample as gs
    model, mb, _, _ = _graph_scene(card, **SMALL)
    t = (mb["neut_avgtex"], mb["neut_verts"])

    def launched(fn):
        n = gs.grid_sample_kernels.launches
        fn()
        torch.cuda.synchronize()
        return gs.grid_sample_kernels.launches - n

    eager = launched(lambda: _eager(model, mb, *t))
    got = [launched(lambda: decode(model, mb, *t)) for _ in range(4)]
    for name in GRAPHED:
        assert _counts(getattr(model, name).graphs) == (1, 3, 2, 0), name
    assert eager > 0
    assert got == [eager, 2 * eager, eager, eager]


# the 262k configuration's model at its widths (configs/config-synthetic-262k.yaml):
# 262,144 primitives of 2^3 on the 1024^2 slab, 512x334 rays, the two-stage cull
PRIMS_262K = dict(batch=1, height=512, width=334, nprims=262144, texsize=1024, primsize=2,
                  raymarch_options={"tile": 16, "max_hit": 64})


def test_graphed_decode_is_eager_bitwise_at_262k(card):
    """16 decodes (8 frames, self- then cross-driven) of the 262k model: each
    graphed decode equals the eager one bit for bit, and the three modules
    replay from their graphs with no failed capture."""
    model, mb, tex, verts = _graph_scene(card, **PRIMS_262K)
    targets = ((mb["neut_avgtex"], mb["neut_verts"]), (tex, verts))
    want = [_eager(model, mb, *t) for t in targets]
    got = [decode(model, mb, *t) for _ in range(8) for t in targets]
    torch.cuda.synchronize()
    assert {name: _counts(getattr(model, name).graphs)[:2] for name in GRAPHED} == {
        "identity_encoder": (2, 14), "expression_encoder": (1, 15), "decoder_assembler": (2, 14)}
    assert all(_counts(getattr(model, name).graphs)[3] == 0 for name in GRAPHED)
    assert float(want[0].abs().sum()) > 0
    for i, image in enumerate(got):
        assert torch.equal(image, want[i % 2]), i
