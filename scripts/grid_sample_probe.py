# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The grid-sample kernels on the card, at the shapes and layouts of one
flagship training step's 17 calls: synthetic calls made without the model,
or the model's own calls.

    python3 scripts/grid_sample_probe.py [--root DIR] [--check] [--reps N]
        [--model [--checkpoint CKPT]] [--save-calls F | --calls F] [--routes]

The synthetic calls have the model's shapes (``models/encoders/
identity.py``, ``models/decoders/geometry.py``): each level of the two bias
pyramids (batch 4, 1024^2 x 3 down to 8^2 x 256) an NHWC view of
channels-first planes (the model's own levels are channels-last where
their convolutions run channels-last: ``--model``), sampled on the identity
grid plus a small random warp, resized to the level and expanded over the
batch; the vertex sampling a 256^2 x 3 geometry map at 7,306 vertices ([4,
7306, 1, 2], expanded). gout comes in the image's layout, as autograd
hands it over. Inputs from seeded generators.

Printed per call: the forward kernel's ms, the backward's ms and its
launches, the route, and the whole path as a training step runs it
(``grid_sample_2d`` forward and ``torch.autograd.grad``: the wrapper's
copies and scale ops included); then one JSON line with the totals. Times
are the mean over ``--reps`` rounds by CUDA events, after a warm-up: on
small levels they are the host's time per call. The last line also holds
the device time of one round under torch.profiler (every kernel, copy and
fill the wrapper launched, by name), which the host does not pace.

``--model`` records the calls of one forward of the flagship model
(``configs/config-synthetic-flagship.yaml``, weights from seed 0, or from a
``cli.train`` checkpoint with ``--checkpoint``: a trained warp) with their
values and strides, and draws each gout in the image's layout from a seeded
generator. ``--save-calls F`` writes the calls to F (``torch.save`` keeps
their strides); ``--calls F`` replays them, so that another tree's kernels
(``--root``) time the very same inputs. ``--routes`` (this tree's wrapper)
also prints, for each warp level, the device's escape count and the
backward's device time (torch.profiler, the mean of ``--reps`` calls) on
each route forced.

``--root DIR`` imports ``ava256_tpu_torch`` from DIR (another tree, e.g. the
parent commit unpacked with ``git archive``), so two versions of the
kernels time the same calls in one process each. ``--check`` (this tree's
wrapper only) also holds the image gradient bitwise to
``grid_sample_bwd_fixed_plain`` at the kernel's scale, the two routes
bitwise to each other, the escape count to ``escape_count_plain``, the
outputs and gradients to ``F.grid_sample`` at the forward and backward
limits, a rerun bitwise, and a warp displaced past the owner route's radius
(the scatter route behind the owner kernel) exactly.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

BSIZE = [3, 16, 32, 64, 64, 128, 128, 256]  # identity.py _BSIZE at imsize 1024
BATCH, IMSIZE, WSIZE, GEO, NVERT = 4, 1024, 128, 256, 7306
RTOL = ATOL = 1e-5
BWD_TOL, BWD_COS = 2e-5, 0.99999


def make_calls(torch, gs, dev, seed=0, warp_scale=0.05):
    """[(site, img, grid, gout)] of one step, as the model lays them out."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.linspace(-1.0, 1.0, WSIZE, device=dev)
    yg, xg = torch.meshgrid(xs, xs, indexing="ij")
    warp = torch.stack([xg, yg], -1)[None]
    warp = warp + warp_scale * torch.randn(warp.shape, device=dev, generator=gen) / WSIZE
    calls = []
    for pyramid in ("geo", "tex"):
        for i, c in enumerate(BSIZE):
            s = IMSIZE >> i
            x = torch.randn((BATCH, c, s, s), device=dev, generator=gen)
            img = torch.where(x >= 0, x, 0.2 * x).permute(0, 2, 3, 1)
            grid = gs.resize_bilinear(warp, (s, s)).expand(BATCH, -1, -1, -1)
            gout = torch.randn((BATCH, c, s, s), device=dev, generator=gen).permute(0, 2, 3, 1)
            calls.append((f"{pyramid}{i}", img, grid, gout))
    geo = torch.randn((BATCH, 3, GEO, GEO), device=dev, generator=gen).permute(0, 2, 3, 1)
    coords = torch.rand((1, NVERT, 1, 2), device=dev, generator=gen) * 2.0 - 1.0
    gout = torch.randn((BATCH, 3, NVERT, 1), device=dev, generator=gen).permute(0, 2, 3, 1)
    calls.append(("vertex", geo, coords.expand(BATCH, -1, -1, -1), gout))
    return calls


def model_calls(torch, dev, checkpoint=None, seed=11):
    """[(site, img, grid, gout)] of one forward of the flagship model, as
    the model makes them (chip_smoke.record_grid_samples does the same)."""
    import importlib

    from ava256_tpu_torch.data.loader import Uploader
    from ava256_tpu_torch.data.synthetic import SyntheticDataset, none_collate, synthetic_uvdata
    from ava256_tpu_torch.factory import get_autoencoder
    from ava256_tpu_torch.flagship import FLAGSHIP as f
    from ava256_tpu_torch.render import BATCH_MODEL_KEYS
    from ava256_tpu_torch.train import loop

    ds = SyntheticDataset(nident=f["nident"], ncams=f["ncams"], nframes=f["nframes"],
                          height=f["height"], width=f["width"], texsize=f["texsize"])
    model = get_autoencoder(
        synthetic_uvdata(f["texsize"]), ds.vertmean, ds.vertstd, ncams=f["ncams"],
        nident=f["nident"], nprims=f["nprims"], primsize=(f["primsize"],) * 3,
        raymarch_options={"tile": f["tile"], "max_hit": f["max_hit"]}, device=dev, seed=0)
    if checkpoint:
        state = torch.load(checkpoint, map_location=dev, weights_only=True)
        model.load_state_dict(state["model"])
    model.eval()
    batch = Uploader(dev).now(loop.to_model_batch(none_collate(
        [ds[i] for i in range(f["batch"])])))
    calls, saved = [], {}
    sites = ("models.encoders.identity", "models.decoders.geometry")
    mods = {site: importlib.import_module(f"ava256_tpu_torch.{site}") for site in sites}

    def recorder(site, fn):
        def rec(img, grid, align_corners=False):
            assert not align_corners, "the model samples with align_corners False"
            dtype = torch.promote_types(img.dtype, grid.dtype)
            calls.append((site, img.detach().to(dtype).clone(), grid.detach().to(dtype)))
            return fn(img, grid, align_corners)
        return rec

    try:
        for site, mod in mods.items():
            saved[site] = mod.grid_sample_2d
            mod.grid_sample_2d = recorder(site.split(".")[-1], saved[site])
        with torch.no_grad():
            model(target_neut_avgtex=batch["neut_avgtex"], target_neut_verts=batch["neut_verts"],
                  idindex=batch["idindex"], camindex=batch["camindex"], deterministic=True,
                  output_set=frozenset({"irgbrec"}), **{k: batch[k] for k in BATCH_MODEL_KEYS})
    finally:
        for site, mod in mods.items():
            mod.grid_sample_2d = saved[site]
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for i, (site, img, grid) in enumerate(calls):
        n, c, (ho, wo) = img.shape[0], img.shape[3], grid.shape[1:3]
        if img.shape[3] == 1 or img.stride(3) != 1:  # as autograd hands it over
            gout = torch.randn((n, c, ho, wo), device=dev, generator=gen).permute(0, 2, 3, 1)
        else:
            gout = torch.randn((n, ho, wo, c), device=dev, generator=gen)
        out.append((f"{site}{i}", img, grid, gout))
    del model
    torch.cuda.empty_cache()
    return out


def bwd_device_ms(torch, k, img, grid, gout, reps, **bwd) -> float:
    """The mean device time of ``reps`` backward calls under torch.profiler
    (every kernel the call launched)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    k.backward(img, grid, gout, **bwd)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            k.backward(img, grid, gout, **bwd)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        events = json.loads(Path(f"{tmp}/trace.json").read_text())["traceEvents"]
    return sum(e["dur"] for e in events if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")) / 1e3 / reps


def cuda_ms(torch, fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def path_fn(torch, gs, img, grid, gout):
    """The grid sample as a training step runs it: the Function's forward and
    backward on leaves shaped as the model's (the grid expanded inside)."""
    leaf_img = img.detach().requires_grad_()
    leaf_grid = grid[:1].detach().requires_grad_()
    n = img.shape[0]

    def run():
        out = gs.grid_sample_2d(leaf_img, leaf_grid.expand(n, -1, -1, -1))
        torch.autograd.grad(out, (leaf_img, leaf_grid), gout)

    return run


def device_ms(torch, k, calls, **bwd) -> dict:
    """One round of the kernels' forward and backward over every call under
    torch.profiler: the device time of every kernel, copy and fill the
    wrapper launched (its copies and scale ops included), summed by name
    from the Chrome trace."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _, img, grid, gout in calls:
            k.forward(img, grid)
            k.backward(img, grid, gout, **bwd)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        events = json.loads(Path(f"{tmp}/trace.json").read_text())["traceEvents"]
    by = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            name = e["name"].replace("(anonymous namespace)::", "").split("(")[0][-48:]
            n, ms = by.get(name, (0, 0.0))
            by[name] = (n + 1, ms + e["dur"] / 1e3)
    return dict(device_ms=round(sum(ms for _, ms in by.values()), 4),
                device_launches=sum(n for n, _ in by.values()),
                by_kernel={k: (n, round(ms, 4)) for k, (n, ms) in
                           sorted(by.items(), key=lambda kv: -kv[1][1])})


def rel(torch, got, ref):
    got, ref = got.double().cpu(), ref.double().cpu()
    err = float((got - ref).abs().max() / ref.abs().max())
    cos = float((got * ref).sum() / torch.sqrt((got * got).sum() * (ref * ref).sum()))
    return err, cos


def escapes(gs, img, grid) -> int:
    """escape_count_plain at the owner kernel's tiles for this call."""
    n, h, w, c = img.shape
    p = gs.owner_plan(n, h, w, c, grid.stride(0) == 0 or n == 1)
    return gs.escape_count_plain(grid, h, w, p["tw"], p["th"])


def check(torch, gs, fixed_point, calls, dev):
    """--check: every held equality; returns the worst errors."""
    k = gs.grid_sample_kernels
    worst = dict(out=0.0, d_img=0.0, d_grid=0.0)
    for site, img, grid, gout in calls:
        out = k.forward(img, grid)
        gimg, ggrid = k.backward(img, grid, gout)
        scale = k.last_scale.clone()
        count = int(k.last_count)
        out2 = k.forward(img, grid)
        gimg2, ggrid2 = k.backward(img, grid, gout)
        if not (torch.equal(out, out2) and torch.equal(gimg, gimg2) and torch.equal(ggrid, ggrid2)):
            raise AssertionError(f"{site}: a rerun differs")
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(False)
        try:
            plain = gs.grid_sample_bwd_fixed_plain(img, grid, gout, scale)
            ref = gs.grid_sample_plain(img, grid)
            rimg, rgrid = gs.grid_sample_bwd_plain(img, grid, gout)
        finally:
            torch.use_deterministic_algorithms(was)
        if not torch.equal(gimg, plain):
            d = (gimg - plain).abs()
            raise AssertionError(f"{site}: d_img differs from the plain fixed point in "
                                 f"{int((d != 0).sum())} cells (max {float(d.max()):.3g})")
        if grid.shape[1:3] == img.shape[1:3]:
            want = escapes(gs, img, grid)
            if count != want or count != 0:
                raise AssertionError(f"{site}: escape count {count}, plain {want}")
            for route in ("owner", "scatter"):
                for fuse in (True, False):
                    gi, gg = k.backward(img, grid, gout, route=route, fuse_grid=fuse)
                    if not torch.equal(gi, gimg):
                        raise AssertionError(f"{site}: route {route} (fuse {fuse}) d_img differs")
        err = (out - ref).abs()
        if bool((err > ATOL + RTOL * ref.abs()).any()):
            raise AssertionError(f"{site}: output beyond rtol/atol (max {float(err.max()):.3g})")
        worst["out"] = max(worst["out"], float(err.max()))
        for name, a, b in (("d_img", gimg, rimg), ("d_grid", ggrid, rgrid)):
            e, cos = rel(torch, a, b)
            if e > BWD_TOL or cos <= BWD_COS:
                raise AssertionError(f"{site} {name}: {e:.3g} of max |ref|, cosine {cos:.8f}")
            worst[name] = max(worst[name], e)
    # a warp displaced past the radius: the owner kernel stands down, the
    # scatter route behind it gives the same bits as the plain version
    _, img, grid, gout = next(c for c in calls if c[2].shape[1:3] == c[1].shape[1:3]
                              and c[1].shape[1] * c[1].shape[2] >= 256 * 256)
    far = grid + 4.0 * (gs.OWNER_RADIUS + 1) / img.shape[2]
    fb = k.fallbacks()
    gimg, _ = k.backward(img, far, gout, route="owner")
    plain = gs.grid_sample_bwd_fixed_plain(img, far, gout, k.last_scale)
    if not (torch.equal(gimg, plain) and int(k.last_count) == escapes(gs, img, far) > 0
            and k.fallbacks() == fb + 1):
        raise AssertionError("a displaced warp: the scatter route behind the owner kernel "
                             "is not exact")
    fixed_point.check(dev)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--per-call", action="store_true",
                    help="also print each call's device time by kernel")
    ap.add_argument("--deterministic", action="store_true",
                    help="time with torch's deterministic mode on, as the training step runs "
                         "(factory.get_autoencoder's settings)")
    ap.add_argument("--model", action="store_true",
                    help="the flagship model's own calls in place of the synthetic ones")
    ap.add_argument("--checkpoint", help="with --model: the weights of a cli.train checkpoint")
    ap.add_argument("--save-calls", help="write the calls (and gouts) to this file")
    ap.add_argument("--calls", help="replay the calls of a file written by --save-calls")
    ap.add_argument("--routes", action="store_true",
                    help="each warp level's escape count and backward device time on the "
                         "picked route and on the scatter route forced")
    ap.add_argument("--variants", action="store_true",
                    help="also the three largest warp levels' device time as they run, with "
                         "the grid gradient unfused, without the grid gradient, without the "
                         "image gradient")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print("grid_sample_probe: CUDA is not available", file=sys.stderr)
        return 1
    from ava256_tpu_torch.ops import fixed_point
    from ava256_tpu_torch.ops import grid_sample as gs

    dev = torch.device("cuda", 0)
    if args.deterministic:
        torch.use_deterministic_algorithms(True)
        torch.utils.deterministic.fill_uninitialized_memory = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    k = gs.grid_sample_kernels
    gs.GRID_SAMPLE_LIB.build()
    if args.calls:
        calls = torch.load(args.calls, map_location=dev, weights_only=True)
    elif args.model:
        calls = model_calls(torch, dev, args.checkpoint)
    else:
        calls = make_calls(torch, gs, dev)
    if args.save_calls:
        torch.save(calls, args.save_calls)
    worst = check(torch, gs, fixed_point, calls, dev) if args.check else None
    largest = sorted((c for c in calls if c[2].shape[1:3] == c[1].shape[1:3]),
                     key=lambda c: -c[1].numel())[:3]
    for variant in (dict(), dict(fuse_grid=False), dict(need_grid=False),
                    dict(need_img=False)) * args.variants:
        for site, img, grid, gout in largest:
            print(json.dumps(dict(site=site, variant=variant,
                                  **device_ms(torch, k, [(site, img, grid, gout)], **variant))))
    rows, tot = [], dict(fwd_ms=0.0, bwd_ms=0.0, path_ms=0.0)
    for site, img, grid, gout in calls:
        fwd = cuda_ms(torch, lambda: k.forward(img, grid), args.reps)
        before = (k.bwd_launches, getattr(k, "bwd_kernels", None))
        bwd = cuda_ms(torch, lambda: k.backward(img, grid, gout), args.reps)
        kernels = (None if before[1] is None else
                   (k.bwd_kernels - before[1]) / (k.bwd_launches - before[0]))
        path = cuda_ms(torch, path_fn(torch, gs, img, grid, gout), args.reps)
        route = None
        if hasattr(k, "owner_launches"):
            owner = k.owner_launches
            k.backward(img, grid, gout)
            route = "owner" if k.owner_launches > owner else "scatter"
        if args.per_call:
            print(json.dumps(dict(site=site, **device_ms(torch, k, [(site, img, grid, gout)]))))
        row = dict(site=site, img=list(img.shape), img_strides=list(img.stride()),
                   grid=list(grid.shape[1:3]), grid_strides=list(grid.stride()),
                   fwd_ms=round(fwd, 5), bwd_ms=round(bwd, 5), path_ms=round(path, 5),
                   bwd_kernels_per_call=kernels, route=route)
        if args.routes and grid.shape[1:3] == img.shape[1:3]:
            k.backward(img, grid, gout, route="owner")
            row.update(escapes=int(k.last_count), **{
                f"bwd_{r}_device_ms": round(bwd_device_ms(torch, k, img, grid, gout, args.reps,
                                                          route=r), 5)
                for r in ("owner", "scatter")})
            if row["escapes"] and route == "owner":
                route = row["route"] = "scatter (the escape count is not 0)"
        print(json.dumps(row), flush=True)
        rows.append(row)
        for key in tot:
            tot[key] += row[key]
    fallbacks = k.fallbacks() if hasattr(k, "fallbacks") else None
    dev_time = device_ms(torch, k, calls)
    if args.routes:  # over the warp levels
        for key in ("bwd_owner_device_ms", "bwd_scatter_device_ms", "escapes"):
            dev_time[f"warp_levels_{key}"] = round(sum(r.get(key, 0) for r in rows), 5)
    print(json.dumps(dict(root=args.root, device=smi, calls=len(rows), reps=args.reps,
                          source=args.calls or ("model " + (args.checkpoint or "seed 0")
                                                if args.model else "synthetic"),
                          deterministic=args.deterministic,
                          pair_ms=round(tot["fwd_ms"] + tot["bwd_ms"], 4),
                          fwd_ms=round(tot["fwd_ms"], 4), bwd_ms=round(tot["bwd_ms"], 4),
                          path_ms=round(tot["path_ms"], 4), fallbacks=fallbacks,
                          checked=worst, **dev_time)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
