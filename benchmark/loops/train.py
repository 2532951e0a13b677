"""The ``train`` loop: the program's training loop as its entry point
composes it (``train/loop.py``), steps after warm-up.

Set-up builds one training state: the dataset with its held-out cameras,
the topology and its UV maps, the model with the benchmark's weights, the
conditioning tables on the device and the lean loader (``ShardedLoader``
shuffled by the seed, the configuration's thread workers, ``device_prefetch``
and ``Uploader``), the optimizer and ``make_train_step``'s step. It takes
the first ``checked_steps`` steps through the same call and feed the
window uses (the first ``warmup_steps`` of them with the warm-up switches:
the adaptive primitive scale, the ground-truth geometry, no residuals),
then hands that state to the window. Each step draws its noise from
``step_generator(device, step, seed)``, reads its loss on the host and
checks the backward kernels' fixed-point flag, as the loop does.

The reference then follows the checked steps from the same weights, items
and noise; the window's rate is images over its seconds."""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from ava256_tpu_torch.data.cond_cache import LeanView, cached_field_names, tables_to_device
from ava256_tpu_torch.data.loader import ShardedLoader, Uploader, device_prefetch
from ava256_tpu_torch.ops import fixed_point
from ava256_tpu_torch.train import loop
from ava256_tpu_torch.train.state import TrainState, make_optimizer
from ava256_tpu_torch.train.step import make_train_step, step_generator

from benchmark.harness import check, program, trace, weights, yardstick
from benchmark.reference import steps as ref_steps
from benchmark.reference import uv as ref_uv

GS_KERNELS = ("fwd_pixels", "fwd_packed4", "bwd_prep", "bwd_owner", "bwd_scatter", "zero_table",
              "to_float<1>")


class TrainRun:
    """One training state of the cell; ``prog``, when given, is a built
    ``Program`` whose model takes the run's weights anew."""

    def __init__(self, run, prog=None):
        self.run = run
        dev = run.device
        self.prog = prog = prog or program.Program(run.conf["config"], run.assets, dev)
        cfg = prog.cfg
        self.seed = run.seed % 2 ** 31
        self.init = prog.load_weights(run.seed)
        tables = prog.dataset.conditioning_tables()
        self.cond = tables_to_device(tables, dev)
        lean = LeanView(prog.dataset, cached_field_names(tables))
        self.batch = int(cfg.train.batchsize)
        self.loader = ShardedLoader(program.Indexed(lean), batch_size=self.batch, shuffle=True,
                                    seed=self.seed, num_workers=cfg.train.num_workers)
        self.optimizer = make_optimizer(prog.model, cfg.train.get("optimizer", "adam"),
                                        cfg.train.init_learning_rate, cfg.train.gamma,
                                        cfg.train.lr_scheduler_iter, cfg.train.clip)
        self.state = TrainState(prog.model, self.optimizer, 0)
        self.train_step = make_train_step(prog.model, self.optimizer, dict(cfg.train.losses),
                                          prog.dataset.vertmean, prog.dataset.vertstd,
                                          output_set=frozenset(cfg.train.output_set))
        upload = Uploader(dev)
        self.order: List[List[int]] = []

        def feed(b):
            self.order.append([int(i) for i in b["bench_index"]])
            return upload(loop.to_model_batch(b))

        def epochs():
            while True:
                yield from self.loader

        self.feed = device_prefetch(epochs(), feed)
        self.it = 0
        self.waits: List[float] = []

    def step(self, mark=None) -> bool:
        """One step as the loop takes it; False where it failed."""
        t = time.perf_counter()
        mb = next(self.feed)
        self.waits.append(time.perf_counter() - t)
        warm = self.it < self.run.traffic["warmup_steps"]
        dev = self.run.device
        self.state, loss, terms = self.train_step(
            self.state, mb, generator=step_generator(dev, self.it, self.seed),
            running_avg_scale=warm, use_gt_geo=warm, residuals_weight=0.0 if warm else 1.0,
            cond=self.cond, mark=mark)
        self.last = {"total": float(loss), **{k: float(v) for k, v in terms.items()}}
        self.it += 1
        try:
            fixed_point.check(dev)
        except fixed_point.FixedPointOverflow:
            return False
        return math.isfinite(self.last["total"])

    def checked_steps(self) -> dict:
        """The first steps, with what the comparison reads of them."""
        params = dict(self.prog.model.named_parameters())
        losses, grad = [], {}
        for s in range(self.run.traffic["checked_steps"]):
            self.step()
            losses.append(self.last)
            if s == 0:  # Adam's first moment after one update is (1 - 0.9) g
                st = self.optimizer.core.state
                names = [k for k, p in params.items() if "exp_avg" in st.get(p, {})]
                norms = [torch.linalg.vector_norm(st[params[k]]["exp_avg"]) / 0.1
                         for k in names]
                grad = dict(zip(names, torch.stack(norms).tolist() if norms else []))
        with torch.no_grad():
            norms = torch.stack([torch.linalg.vector_norm(p.detach() - self.init[k])
                                 for k, p in params.items()])
        self.init = None
        return {"losses": losses, "grad": grad, "change": dict(zip(params, norms.tolist()))}

    def close(self):
        self.feed.close()
        self.loader.close()


def run(r) -> dict:
    """Set-up, window, trace and comparison of one run; returns the parts
    of the result line."""
    dev = r.device
    tr = TrainRun(r)
    prog_reading = tr.checked_steps()
    setup_s = time.perf_counter() - r.t0
    rec: Dict = {"loop": "train", "batch": tr.batch, "gpu": dev.type == "cuda"}
    marks = []

    def mark_fn(store):
        def mark(name):
            if dev.type == "cuda":
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                store[name] = ev
        return mark

    steps = failed = 0
    waits0 = len(tr.waits)
    t_start = time.perf_counter()
    while True:
        m = {}
        ok = tr.step(mark_fn(m) if r.trace else None)
        if r.trace:
            marks.append(m)
        steps += 1
        failed += not ok
        if time.perf_counter() - t_start >= r.seconds:
            break
    window_s = time.perf_counter() - t_start
    rec.update(steps=steps, window_s=window_s, loader_wait_s=tr.waits[waits0:])
    if r.trace:
        if dev.type == "cuda":
            torch.cuda.synchronize()
            rec["optimizer_s"] = [m["backward"].elapsed_time(m["optimizer"]) / 1e3
                                  for m in marks if "optimizer" in m]
        rec["events"] = trace.profile(tr.step, r.traffic["profiled_steps"], tr.prog.model,
                                      r.out_dir / "trace.json")
        c = yardstick.counts(tr.prog.dims, tr.batch, *tr.prog.dataset.get_img_size(), True)
        rec.update(flops_per_unit=c["flops"], grid_sample_bytes_per_unit=c["grid_sample_bytes"],
                   peak_flops=yardstick.PEAK_FLOPS[r.conf["config"]["model"].get("dtype")
                                                   or "float32"],
                   gs_kernels=GS_KERNELS)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    order = tr.order[: r.traffic["checked_steps"]]
    dims, dataset = tr.prog.dims, tr.prog.dataset
    train_cfg = dict(r.conf["config"]["train"])
    tr.close()
    del tr
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref_reading = reference(r, dims, dataset, order, train_cfg, tf32=False)
    rec["reference_s"] = time.perf_counter() - t_ref
    numbers = check.train_numbers(prog_reading, ref_reading)
    return dict(setup_s=setup_s, attempted=steps, failed=failed,
                metrics={"train_images_per_s": steps * rec["batch"] / window_s},
                records=rec, memory_peak_bytes=peak, numbers=numbers)


def reference(r, dims, dataset, order, train_cfg, tf32: bool) -> dict:
    """The reference's readings of the checked steps (``tf32``: its
    convolutions and matrix products in TF32, the control)."""
    dev = r.device
    uv = ref_uv.uv_maps(r.assets / "face_topology.obj", dims["uv_res"], r.cache_dir)
    state = weights.make(dims, r.seed, dev)
    model = ref_steps.build(dims, uv, dataset.vertmean, dataset.vertstd, state, dev)
    seed = r.seed % 2 ** 31  # the noise of step s: the program's step_generator(seed, s)
    batches = [ref_steps.collate([dataset[i] for i in idx], dev) for idx in order]
    noises = [torch.randn((len(idx), 4, 4, 16), device=dev,
                          generator=torch.Generator(device=dev).manual_seed((seed << 32) + s))
              for s, idx in enumerate(order)]
    warm = [s < r.traffic["warmup_steps"] for s in range(len(order))]
    with ref_steps.precision(tf32):
        return ref_steps.train(model, batches, noises, warm, train_cfg)


def half_batches():
    """The fault of half of each batch left out, the mean taken over the
    rest, planted in the program's step; returns its undo."""
    from ava256_tpu_torch.train import step

    full = step.expand_batch

    def half(batch, cond):
        b = full(batch, cond)
        n = b["image"].shape[0] // 2
        return {k: v[:n] for k, v in b.items()}

    step.expand_batch = half
    return lambda: setattr(step, "expand_batch", full)


def leaves(model, prog: dict, ref: dict, top: int = 8) -> dict:
    """The leaves whose change and first gradient part most: name, size,
    the program's and the reference's change, first gradient and largest
    gradient norms."""
    sizes = {k: p.numel() for k, p in model.named_parameters()}
    medc = float(np.median(list(ref["change"].values())))
    medg = float(np.median(list(ref["grad"].values())))

    def row(k):
        return [k, sizes.get(k), prog["change"].get(k), ref["change"][k], prog["grad"].get(k),
                ref["grad"].get(k), ref["grad_max"].get(k)]

    def gap(kind, med):
        return lambda k: -abs(prog[kind].get(k, 0.0) - ref[kind][k]) / max(ref[kind][k], med)

    return {"median_change": medc, "median_grad": medg,
            "change": [row(k) for k in sorted(ref["change"], key=gap("change", medc))[:top]],
            "grad": [row(k) for k in sorted(ref["grad"], key=gap("grad", medg))[:3]]}


def readings(r, seeds, n_control: int, n_faults: int):
    """For each seed the numbers of a sound run with its widest leaves; for
    the first ``n_control`` the TF32 control's; for the first ``n_faults``
    those of half of each batch left out (a state left unchanged reads 1 by
    construction and needs no run)."""
    prog = program.Program(r.conf["config"], r.assets, r.device)
    train_cfg = dict(r.conf["config"]["train"])
    for i, seed in enumerate(seeds):
        r.seed = seed
        t0 = time.perf_counter()
        tr = TrainRun(r, prog)
        reading = tr.checked_steps()
        order = tr.order[: r.traffic["checked_steps"]]
        tr.close()
        t1 = time.perf_counter()
        ref = reference(r, prog.dims, prog.dataset, order, train_cfg, tf32=False)
        t2 = time.perf_counter()
        yield dict(seed=seed, kind="sound", **check.train_numbers(reading, ref),
                   program_s=t1 - t0, reference_s=t2 - t1, losses=reading["losses"],
                   ref_losses=ref["losses"], leaves=leaves(prog.model, reading, ref))
        if i < n_control:
            ctl = reference(r, prog.dims, prog.dataset, order, train_cfg, tf32=True)
            yield dict(seed=seed, kind="control_tf32", **check.train_numbers(ctl, ref))
        if i < n_faults:
            undo = half_batches()
            try:
                tr = TrainRun(r, prog)
                bad = tr.checked_steps()
                tr.close()
            finally:
                undo()
            yield dict(seed=seed, kind="fault_half_batch", **check.train_numbers(bad, ref))
