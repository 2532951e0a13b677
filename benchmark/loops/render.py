"""The ``render`` loop: the program's ``cli.render`` decode, one frame at a
time. A frame is one request: the model inputs of one of the driver
identity's items, uploaded (``Uploader.now``), decoded self-driven and
cross-identity-driven (the driven identity's neutral conditioning) by
``render.decode``, and both images copied to the host; its latency runs
from the upload to the images on the host.

Set-up builds the model with the benchmark's weights, fetches a pool of
the first ``frame_pool`` of the driver's items of the training split in
dataset order (the same frames for every seed, in an order the seed
draws), scales the primitives from the ground-truth geometry of the first
in that order (the warm-up forward of training: ``running_avg_scale``,
residuals off) and renders ``warm_frames`` frames. The window cycles through the pool.
The items are fetched in set-up because the synthetic dataset renders
each item's ground-truth image on the host, which ``cli.render`` only
writes into its strip. After the window a sample of its frames, drawn from
the seed, is decoded again by the reference."""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from ava256_tpu_torch.data.dataset import none_collate
from ava256_tpu_torch.data.loader import Uploader
from ava256_tpu_torch.render import BATCH_MODEL_KEYS, decode
from ava256_tpu_torch.train.loop import to_model_batch

from benchmark.harness import check, program, trace, weights, yardstick
from benchmark.reference import steps as ref_steps
from benchmark.reference import uv as ref_uv

def driver_frames(ds, driver: int, count: int, seed: int) -> List[int]:
    """The first ``count`` of the driver's items of the split in dataset
    order (the same frames for every seed), in an order the seed draws. The
    split keeps whole cameras of the identity-major item layout, so its
    items cycle through the identities (each item is checked)."""
    frames = [i for i in range(len(ds)) if i % len(ds.identities) == driver][:count]
    return [frames[i] for i in np.random.RandomState(seed % 2 ** 31).permutation(len(frames))]


def run(r) -> dict:
    dev, tf = r.device, r.traffic
    prog = program.Program(r.conf["config"], r.assets, dev)
    prog.load_weights(r.seed)
    ds, model = prog.dataset, prog.model
    frames = driver_frames(ds, tf["driver_index"], tf["frame_pool"], r.seed)
    pool = [ds[i] for i in frames]
    for i, item in zip(frames, pool):
        if int(item["idindex"]) != tf["driver_index"]:
            raise RuntimeError(f"item {i} is of identity {int(item['idindex'])}, not the "
                               f"driver {tf['driver_index']}")
    upload = Uploader(dev)
    driven = ds.get_neutral_conditioning(tf["driven_index"])
    driven_tex = torch.from_numpy(driven["neut_avgtex"][None]).to(dev)
    driven_verts = torch.from_numpy(driven["neut_verts"][None]).to(dev)

    first = upload.now(to_model_batch(none_collate([pool[0]])))
    with torch.inference_mode():
        model(target_neut_avgtex=first["neut_avgtex"], target_neut_verts=first["neut_verts"],
              idindex=first["idindex"], camindex=first["camindex"], running_avg_scale=True,
              gt_geo=first["verts"], residuals_weight=0.0, deterministic=True,
              **{k: first[k] for k in BATCH_MODEL_KEYS})
    pos = [0]

    def frame():
        k = pos[0] % len(frames)
        pos[0] += 1
        mb = upload.now(to_model_batch(none_collate([pool[k]])))
        a = decode(model, mb, mb["neut_avgtex"], mb["neut_verts"])
        b = decode(model, mb, driven_tex, driven_verts)
        return frames[k], a[0].cpu().numpy(), b[0].cpu().numpy()

    for _ in range(tf["warm_frames"]):
        frame()
    setup_s = time.perf_counter() - r.t0

    done: List = []
    lat: List[float] = []
    failed = 0
    t_start = time.perf_counter()
    while True:
        t = time.perf_counter()
        out = frame()
        lat.append(time.perf_counter() - t)
        done.append(out)
        failed += not (np.isfinite(out[1]).all() and np.isfinite(out[2]).all())
        if time.perf_counter() - t_start >= r.seconds:
            break
    window_s = time.perf_counter() - t_start
    rec: Dict = {"loop": "render", "steps": len(done), "window_s": window_s,
                 "gpu": dev.type == "cuda"}
    if r.trace:
        rec["events"] = trace.profile(frame, tf["profiled_frames"], model,
                                      r.out_dir / "trace.json")
        h, w = ds.get_img_size()
        rec.update(flops_per_unit=2 * yardstick.counts(prog.dims, 1, h, w, False)["flops"],
                   peak_flops=yardstick.PEAK_FLOPS[r.conf["config"]["model"].get("dtype")
                                                   or "float32"])
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    pick = np.random.RandomState((r.seed + 1) % 2 ** 31).choice(
        len(done), size=min(tf["checked_frames"], len(done)), replace=False)
    checked = [done[i] for i in sorted(pick)]
    first_item = pool[0]
    dims = prog.dims
    del model, prog, done, first, pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    prog_imgs = [im for _, a, b in checked for im in (a, b)]
    t_ref = time.perf_counter()
    ref_imgs = reference(r, dims, ds, first_item, [i for i, _, _ in checked], driven, tf32=False)
    rec["reference_s"] = time.perf_counter() - t_ref
    numbers = check.image_numbers(prog_imgs, ref_imgs)
    lat_sorted = sorted(lat)
    p95 = lat_sorted[min(len(lat) - 1, math.ceil(0.95 * len(lat)) - 1)]
    return dict(setup_s=setup_s, attempted=len(lat), failed=failed,
                metrics={"render_frames_per_s": len(lat) / window_s,
                         "render_frame_p95_ms": p95 * 1e3},
                records=rec, memory_peak_bytes=peak, numbers=numbers)


def reference(r, dims, ds, first_item, idxs, driven, tf32: bool) -> List[np.ndarray]:
    """The reference's images of the frames ``idxs``, self- and cross-driven
    in turn (``tf32``: its convolutions and matrix products in TF32)."""
    dev = r.device
    uv = ref_uv.uv_maps(r.assets / "face_topology.obj", dims["uv_res"], r.cache_dir)
    model = ref_steps.build(dims, uv, ds.vertmean, ds.vertstd, weights.make(dims, r.seed, dev),
                            dev)
    with ref_steps.precision(tf32):
        ref_steps.scale_primitives(model, ref_steps.collate([first_item], dev))
        tex = torch.from_numpy(driven["neut_avgtex"][None]).to(dev)
        verts = torch.from_numpy(driven["neut_verts"][None]).to(dev)
        out = []
        for i in idxs:
            b = ref_steps.collate([ds[i]], dev)
            out.append(ref_steps.decode(model, b, b["neut_avgtex"], b["neut_verts"])[0].cpu()
                       .numpy())
            out.append(ref_steps.decode(model, b, tex, verts)[0].cpu().numpy())
        return out


def readings(r, seeds, n_control: int, n_faults: int):
    """For each seed the numbers of a sound run (a whole run of the loop);
    for the first ``n_control`` the TF32 control's and for the first
    ``n_faults`` those of each answer altered where it is produced (its
    image scaled by 1.01), on the frames after the first in the seed's
    order."""
    for i, seed in enumerate(seeds):
        r.seed = seed
        res = run(r)
        yield dict(seed=seed, kind="sound", **res["numbers"],
                   reference_s=res["records"]["reference_s"], frames=res["attempted"])
        if i >= max(n_control, n_faults):
            continue
        prog = program.Program(r.conf["config"], r.assets, r.device)
        ds, tf = prog.dataset, r.traffic
        frames = driver_frames(ds, tf["driver_index"], tf["frame_pool"], seed)
        args = (r, prog.dims, ds, ds[frames[0]], frames[1: 1 + tf["checked_frames"]],
                ds.get_neutral_conditioning(tf["driven_index"]))
        del prog
        ref = reference(*args, tf32=False)
        if i < n_control:
            yield dict(seed=seed, kind="control_tf32",
                       **check.image_numbers(reference(*args, tf32=True), ref))
        if i < n_faults:
            bad = [im * np.float32(1.01) for im in ref]
            yield dict(seed=seed, kind="fault_answer_altered", **check.image_numbers(bad, ref))
