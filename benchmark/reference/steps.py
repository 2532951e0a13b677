"""The reference's training steps and frame decodes, in plain PyTorch:
forward, the weighted losses, the backward, the scrub of non-finite
gradient entries, the clip of the global norm and Adam (betas 0.9 /
0.999, eps 1e-8) under the step-LR schedule, written out here."""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.model import Autoencoder, compute_losses, total_loss

BATCH_KEYS = ("camrot", "campos", "focal", "princpt", "modelmatrix", "avgtex", "verts",
              "neut_avgtex", "neut_verts", "pixelcoords", "idindex", "camindex", "image")


@contextlib.contextmanager
def precision(tf32: bool):
    """The reference's precision: float32 with TF32 off, or (the control)
    TF32 convolutions and matrix products. PyTorch's deterministic mode,
    which the program turns on for its process, is off meanwhile: the
    reference's scatter-adds take the atomic path."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.are_deterministic_algorithms_enabled())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    torch.use_deterministic_algorithms(False)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags[:2]
        torch.use_deterministic_algorithms(flags[2])


def collate(items: List[dict], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.stack([np.asarray(it[k]) for it in items])).to(device)
            for k in BATCH_KEYS}


def build(dims, uv, vertmean, vertstd, state: Dict[str, torch.Tensor], device) -> Autoencoder:
    model = Autoencoder(dims, uv=uv, vertmean=vertmean, vertstd=vertstd).to_device(device)
    model.load_state_dict(state, strict=True)
    return model


def train(model: Autoencoder, batches, noises, warm: List[bool], train_cfg: dict) -> dict:
    """Steps of ``train_cfg`` (losses, init_learning_rate, gamma,
    lr_scheduler_iter, clip) on the given batches and noises. Returns each
    step's loss terms and total, each leaf's first gradient norm as the
    optimizer gets it, each leaf's change after the last step and its
    largest gradient norm over the steps."""
    weights = dict(train_cfg["losses"])
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    vertmean = model.vertmean
    losses, first_grad, most = [], {}, {}
    for step, (b, noise, w) in enumerate(zip(batches, noises, warm)):
        for p in params.values():
            p.grad = None
        out = model(b, noise=noise, running_avg_scale=w, gt_geo=b["verts"] if w else None,
                    residuals_weight=0.0 if w else 1.0)
        terms = compute_losses(out, b, weights, vertmean, model.vertstd)
        total = total_loss(terms, weights)
        total.backward()
        losses.append({"total": float(total.detach()),
                       **{k: float(t.detach()) for k, t in terms.items()}})
        grads = {k: p.grad for k, p in params.items() if p.grad is not None}
        for g in grads.values():
            torch.nan_to_num_(g, nan=0.0, posinf=0.0, neginf=0.0)
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.where(norm < train_cfg["clip"], torch.ones_like(norm),
                            train_cfg["clip"] / norm)
        lr = train_cfg["init_learning_rate"] * train_cfg["gamma"] ** min(
            step // int(train_cfg["lr_scheduler_iter"]), 1)
        t = step + 1
        with torch.no_grad():
            for k, g in grads.items():
                g = g * scale
                norm_k = float(torch.linalg.vector_norm(g))
                most[k] = max(most.get(k, 0.0), norm_k)
                if step == 0:
                    first_grad[k] = norm_k
                m[k].mul_(0.9).add_(g, alpha=0.1)
                v[k].mul_(0.999).addcmul_(g, g, value=0.001)
                denom = (v[k].sqrt() / (1 - 0.999 ** t) ** 0.5).add_(1e-8)
                params[k].addcdiv_(m[k], denom, value=-lr / (1 - 0.9 ** t))
    change = {k: float(torch.linalg.vector_norm(params[k].detach() - start[k])) for k in most}
    return {"losses": losses, "grad": first_grad, "change": change, "grad_max": most}


@torch.no_grad()
def decode(model: Autoencoder, b: Dict[str, torch.Tensor], target_tex, target_verts):
    """A frame's image with the identity of the given neutral data and the
    bottleneck's mean."""
    return model(dict(b, target_neut_avgtex=target_tex, target_neut_verts=target_verts))["irgbrec"]


@torch.no_grad()
def scale_primitives(model: Autoencoder, b: Dict[str, torch.Tensor]) -> None:
    """The warm-up forward: the adaptive primitive scale from the batch's
    ground-truth geometry."""
    model(b, running_avg_scale=True, gt_geo=b["verts"], residuals_weight=0.0)
