# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The training loop, the body of the JAX package's ``train.py`` on one
device, and what every entry point shares: building the dataset (with the
camera hold-out), the topology and the model from a ``Config``.

``run(cfg)``: the dataset without its held-out cameras; the topology from
``{assets}/face_topology.obj``; the conditioning tables uploaded once, a lean
loader (``LeanView``) and ``cond=`` to every step; ``ShardedLoader`` batches
through ``device_prefetch`` for ``num_epochs`` epochs, resumed with
``set_position``; the warm-up switches for the first ``warmup_iters`` steps;
progress and cross-identity renders (every 100 steps under 10,000, then
every 1,000); a loss line per step with the learning rate; checkpoints at the
cadence and at the end, resuming from the latest one found; tensorboard
scalars when ``progress.tensorboard.logdir`` is set; a trace of step
``progress.profile_at``; the step times in ``timesinfo_r0.npy``.

``mesh.multihost: true`` trains data-parallel with one process per device,
as ``torchrun`` starts them (``ava256_tpu_torch.parallel``): each rank loads
its own shard of every epoch, ``train.batchsize`` items a step (the batch
size is per process, the reference DDP's per-GPU minibatch; the global batch
is ``train.batchsize`` times the world size), and a step is taken only when
every rank has a full batch. Rank 0 alone writes the progress renders,
TensorBoard, the step times, the log lines and the checkpoints.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ava256_tpu_torch import parallel
from ava256_tpu_torch.config import Config
from ava256_tpu_torch.data.cond_cache import (
    LeanView, cached_field_names, expand_batch, table_nbytes, tables_to_device)
from ava256_tpu_torch.data.dataset import (
    CameraSplit, MultiCaptureDataset, last_n_camindices, train_csv_loader)
from ava256_tpu_torch.data.loader import ShardedLoader, Uploader, device_prefetch
from ava256_tpu_torch.data.synthetic import SyntheticDataset
from ava256_tpu_torch.factory import get_autoencoder
from ava256_tpu_torch.geometry import create_uv_baridx
from ava256_tpu_torch.ops import fixed_point
from ava256_tpu_torch.ops.raymarch_cuda import resolve_device
from ava256_tpu_torch.render import BATCH_MODEL_KEYS
from ava256_tpu_torch.train.metrics import psnr
from ava256_tpu_torch.train.profiling import StepTimer, annotate, trace
from ava256_tpu_torch.train.state import (
    TrainState, latest_checkpoint_step, make_optimizer, restore_checkpoint, save_checkpoint)
from ava256_tpu_torch.train.step import make_eval_step, make_train_step, step_generator
from ava256_tpu_torch.utils import render_img

logger = logging.getLogger("ava256_tpu_torch.train")

MODEL_BATCH_KEYS = set(BATCH_MODEL_KEYS) | {"idindex", "camindex", "image"}
# model.raymarch.backend of the configs -> the port's backend
BACKENDS = {"pallas": "cuda", "xla": "xla", "reference": "reference"}
# model.dtype of the configs -> the activations' compute dtype (None: float32)
DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# what every entry point builds
# ---------------------------------------------------------------------------


def build_dataset(cfg: Config, heldout: bool = False):
    """The configured dataset: the synthetic one, or the captures of the
    first ``train.nids`` rows of ``train.data_csv`` under
    ``train.dataset_dir`` at ``train.downsample``. ``data.holdout_cameras:
    N`` reserves the last N cameras: training and rendering iterate the
    others, evaluation with ``heldout=True`` only those."""
    if cfg.data.synthetic:
        base_verts = None
        mesh_bin = Path(cfg.assets) / "021924.bin"
        if mesh_bin.exists():
            base_verts = np.fromfile(mesh_bin, dtype=np.float32).reshape(-1, 3)
        ds = SyntheticDataset(
            nident=cfg.train.nids,
            ncams=int(cfg.data.get("synthetic_cams", 4)),
            nframes=int(cfg.data.get("synthetic_frames", 8)),
            height=cfg.data.synthetic_height,
            width=cfg.data.synthetic_width,
            texsize=cfg.data.synthetic_texsize,
            base_verts=base_verts,
        )
    else:
        captures, dirs = train_csv_loader(cfg.train.dataset_dir, cfg.train.data_csv,
                                          cfg.train.nids)
        ds = MultiCaptureDataset(captures, dirs, downsample=cfg.train.downsample)
    n = int(cfg.data.get("holdout_cameras", 0) or 0)
    if n:
        ds = CameraSplit(ds, last_n_camindices(ds, n), heldout=heldout)
    return ds


def load_uvdata(cfg: Config) -> Dict[str, np.ndarray]:
    """The topology's UV maps at the texture size, from
    ``{assets}/face_topology.obj`` (cached on disk after the first build)."""
    uv_res = cfg.data.synthetic_texsize if cfg.data.synthetic else 1024
    t0 = time.time()
    uvdata = create_uv_baridx(f"{cfg.assets}/face_topology.obj", resolution=uv_res)
    logger.info("UV maps at %d^2 ready (%.2f s)", uv_res, time.time() - t0)
    return uvdata


def build_model(cfg: Config, dataset, uvdata, device, seed: int = 0):
    """The configured autoencoder on ``device``. ``model.dtype: bfloat16``
    computes the activations of the encoders and decoders in bfloat16, as
    the JAX package's ``train.py`` does; any value other than that, float32
    or none is refused (JAX would quietly run float32)."""
    rm = dict(cfg.model.raymarch)
    backend = rm.pop("backend", "pallas")
    if backend not in BACKENDS:
        raise ValueError(f"unknown model.raymarch.backend {backend!r}")
    if cfg.model.get("dtype") not in DTYPES:
        raise ValueError(f"unknown model.dtype {cfg.model.dtype!r}: the port takes "
                         "float32 or bfloat16")
    return get_autoencoder(
        uvdata,
        vertmean=dataset.vertmean,
        vertstd=dataset.vertstd,
        ncams=len(dataset.get_allcameras()),
        nident=len(dataset.identities),
        volradius=cfg.model.volradius,
        nprims=cfg.model.nprims,
        primsize=(cfg.model.primsize,) * 3,
        colorcal=cfg.model.get("colorcal", True),
        bgmodel=cfg.model.get("bgmodel", True),
        raymarch_backend=BACKENDS[backend],
        raymarch_options=rm,
        device=device,
        seed=seed,
        dtype=DTYPES[cfg.model.get("dtype")],
    )


def to_model_batch(batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in batch.items() if k in MODEL_BATCH_KEYS}


# ---------------------------------------------------------------------------
# progress renders
# ---------------------------------------------------------------------------


def _progress_render(eval_step, mb, outpath, iternum):
    t0 = time.time()
    out = eval_step(mb, mb["neut_avgtex"], mb["neut_verts"])
    p = float(psnr(out["irgbrec"], mb["image"]))
    rec = out["irgbrec"].cpu().numpy()
    gt = mb["image"].cpu().numpy()
    rows = [[gt[b], rec[b], (gt[b] - rec[b]) ** 2 * 10] for b in range(gt.shape[0])]
    render_img(rows, str(Path(outpath) / f"progress_{iternum}.png"))
    logger.info("Progress iter %d: PSNR %.2f dB (%.1f ms)", iternum, p,
                (time.time() - t0) * 1e3)


def _xid_render(eval_step, mb, neutral_conds, cfg, outpath, iternum):
    """Drive the first batch element with other identities' neutral data."""
    one = {k: v[:1] for k, v in mb.items()}
    dev = one["image"].device
    rows = [one["image"][0].cpu().numpy()]
    rows.append(eval_step(one, one["neut_avgtex"], one["neut_verts"])["irgbrec"][0].cpu().numpy())
    n = min(cfg.progress.cross_id_n_subjects, len(neutral_conds))
    for i in range(n):
        if i == int(one["idindex"][0]):
            continue
        cond = neutral_conds[i]
        out = eval_step(one, torch.from_numpy(cond["neut_avgtex"][None]).to(dev),
                        torch.from_numpy(cond["neut_verts"][None]).to(dev))
        rows.append(out["irgbrec"][0].cpu().numpy())
    render_img([rows], str(Path(outpath) / "x-id" / f"progress_{iternum}.png"))


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def checkpoint_cadence(step: int, checkpoint_every: Optional[int]) -> int:
    """Steps between mid-run checkpoints at ``step``; 0 or less: none."""
    if checkpoint_every is None:
        return 2_000 if step < 10_000 else 20_000
    return int(checkpoint_every)


def _tensorboard(cfg: Config, outpath: Path):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        logger.warning("tensorboardX unavailable; scalar logging to stdout only")
        return None
    tb = SummaryWriter(str(outpath / cfg.progress.tensorboard.logdir))
    tb.add_hparams({"minibatchsize": cfg.train.batchsize,
                    "globalbatchsize": cfg.train.batchsize * parallel.world_size(),
                    "learningrate": cfg.train.init_learning_rate,
                    "optimizer": cfg.train.get("optimizer", "adam")},
                   {"hp_metric": 1.0})
    return tb


def run(cfg: Config, device="cuda", seed: int = 0) -> TrainState:
    """Train as the configuration says; returns the final state. With
    ``mesh.multihost`` the process joins the group of its launcher's
    environment (``device`` then names the device type; the rank takes
    ``cuda:LOCAL_RANK``) and leaves it at the end, on an error too."""
    device = resolve_device(device)
    multihost = bool(cfg.mesh.get("multihost"))
    owns_group = multihost and not parallel.is_initialized()
    if multihost:
        device = parallel.init_from_env(device)
        logger.info("Process group: backend %s, rank %d of %d, on %s", parallel.backend(),
                    parallel.rank(), parallel.world_size(), device)
    quiet = logging.getLogger("ava256_tpu_torch")
    level = quiet.level
    if parallel.rank() != 0:
        quiet.setLevel(logging.WARNING)  # the log lines are rank 0's
    try:
        return _run(cfg, device, seed)
    finally:
        quiet.setLevel(level)
        if owns_group:
            parallel.destroy()


def _run(cfg: Config, device: torch.device, seed: int) -> TrainState:
    lead, world = parallel.rank() == 0, parallel.world_size()
    outpath = Path(cfg.progress.output_path)
    (outpath / "x-id").mkdir(parents=True, exist_ok=True)
    tb = _tensorboard(cfg, outpath) if cfg.progress.tensorboard.logdir and lead else None

    t0 = time.time()
    dataset = build_dataset(cfg)
    logger.info("Dataset instantiated (%.2f s), %d items", time.time() - t0, len(dataset))
    t0 = time.time()
    model = build_model(cfg, dataset, load_uvdata(cfg), device, seed)
    nparams = sum(p.numel() for p in model.parameters())
    logger.info("Model initialized (%.1f s): %s params", time.time() - t0, f"{nparams:_}")

    # Device-resident conditioning tables: the per-identity / per-camera
    # constant fields are uploaded once and gathered by index inside the
    # step; the loader ships only the per-frame payload.
    cond, loader_dataset = None, dataset
    if cfg.train.get("device_cond_cache", True) and hasattr(dataset, "conditioning_tables"):
        tables = dataset.conditioning_tables()
        cond = tables_to_device(tables, device)
        loader_dataset = LeanView(dataset, cached_field_names(tables))
        logger.info("Conditioning tables on device: %.1f MB (%s), lean loader batches",
                    table_nbytes(tables) / 2**20, ", ".join(sorted(cached_field_names(tables))))

    loader = ShardedLoader(loader_dataset, batch_size=cfg.train.batchsize, shuffle=True,
                           num_workers=cfg.train.num_workers, host_id=parallel.rank(),
                           num_hosts=world)
    optimizer = make_optimizer(model, cfg.train.get("optimizer", "adam"),
                               cfg.train.init_learning_rate, cfg.train.gamma,
                               cfg.train.lr_scheduler_iter, cfg.train.clip)
    state = TrainState(model, optimizer, 0)
    ckpt_dir = outpath / "checkpoints"
    if cfg.train.checkpoint:
        state = restore_checkpoint(cfg.train.checkpoint, state)
        logger.info("Restored checkpoint at step %d", state.step)
    elif latest_checkpoint_step(ckpt_dir) is not None:
        state = restore_checkpoint(ckpt_dir, state)
        logger.info("Resumed from %s at step %d", ckpt_dir, state.step)

    train_step = make_train_step(model, optimizer, dict(cfg.train.losses), dataset.vertmean,
                                 dataset.vertstd, output_set=frozenset(cfg.train.output_set))
    eval_step = make_eval_step(model)
    neutral_conds = [dataset.get_neutral_conditioning(i) for i in range(len(dataset.identities))]

    iternum = state.step
    if iternum > 0:
        # resume the deterministic data order where the checkpoint left off
        loader.set_position(iternum)
    warmup = cfg.train.get("warmup_iters", 100)
    timer = StepTimer()
    profile_at = cfg.progress.get("profile_at", -1)  # step to capture a trace
    profile_dir = str(outpath / "profile")
    upload = Uploader(device)
    done = False

    try:
        iter_end = time.time()
        for _ in range(cfg.train.num_epochs):
            if done:
                break
            stepped = False
            # a feeder thread uploads batch i+1 while batch i computes
            for mb in device_prefetch(loader, lambda b: upload(to_model_batch(b)),
                                      keep_none=world > 1):
                if world > 1 and not parallel.all_ranks(
                        mb is not None and len(mb["idindex"]) == cfg.train.batchsize, device):
                    logger.warning("Step %d skipped: a rank's batch lost items", iternum)
                    continue
                stepped = True
                iter_start = iter_end
                in_warmup = iternum < warmup
                with trace(profile_dir if iternum == profile_at else None), \
                        annotate("train_step"), timer.step():
                    state, loss, terms = train_step(
                        state, mb, generator=step_generator(device, iternum, seed),
                        running_avg_scale=in_warmup, use_gt_geo=in_warmup,
                        residuals_weight=0.0 if in_warmup else 1.0, cond=cond)
                    loss = float(loss)  # the step's result on the host
                    # the backward kernels' integer sums lost no addend
                    fixed_point.check(device)

                # ---- progress renders ----
                if lead and ((iternum < 10_000 and iternum % 100 == 0) or iternum % 1000 == 0):
                    vis_mb = expand_batch(mb, cond)
                    _progress_render(eval_step, vis_mb, outpath, iternum)
                    if cfg.progress.cross_id and len(neutral_conds) > 1:
                        _xid_render(eval_step, vis_mb, neutral_conds, cfg, outpath, iternum)

                # ---- checkpoints ----
                cadence = checkpoint_cadence(iternum, cfg.train.get("checkpoint_every"))
                if cadence > 0 and iternum % cadence == 0 and iternum > 0:
                    save_checkpoint(ckpt_dir, state)
                    logger.info("Saved checkpoint at step %d", iternum)

                iter_end = time.time()
                # the effective rate of the StepLR schedule
                bumped = iternum >= int(cfg.train.lr_scheduler_iter)
                cur_lr = float(cfg.train.init_learning_rate) * (
                    float(cfg.train.gamma) if bumped else 1.0)
                logger.info("Iteration %d loss = %.4f, %s lr = %.2e, time: %.3f s", iternum, loss,
                            ", ".join(f"{k} = {float(v):.4f}" for k, v in terms.items()), cur_lr,
                            iter_end - iter_start)
                if tb is not None and iternum % cfg.progress.tensorboard.log_freq == 0:
                    tb.add_scalar("Total Loss", loss, iternum)
                    tb.add_scalar("lr", cur_lr, iternum)
                    for k, v in terms.items():
                        tb.add_scalar(f"loss/{k}", float(v), iternum)

                iternum += 1
                if iternum >= cfg.train.maxiter:
                    logger.info("Stopping at max iter %d", iternum)
                    if lead:
                        timer.save(str(outpath), rank=0)
                    logger.info("Timing: %s", timer.summary())
                    done = True
                    break
            if not stepped:
                raise RuntimeError("no item of the dataset loaded in a whole epoch")
    finally:
        loader.close()
        if tb is not None:
            tb.close()

    save_checkpoint(ckpt_dir, state)
    logger.info("Final checkpoint saved at step %d", state.step)
    return state
