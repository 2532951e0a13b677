"""The benchmark's own arithmetic: the chip's peaks, the model's operations
per step or frame, and the least bytes of the grid-sample calls. Both counts
come from the reference model (``benchmark/reference``) run on the ``meta``
device at the cell's shapes, so no change to the program moves them.

Operations are ``torch.utils.flop_counter.FlopCounterMode``'s: the
convolutions (transposed too), matrix products and their gradients. The
march and the grid sampling are elementwise and gathers: they are left out
(the march stands in as a free function of its inputs)."""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.reference.model import Autoencoder

# NVIDIA H100 SXM data sheet, dense: float32 outside the tensor cores (the
# configurations run with TF32 off), bfloat16; HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def _march_stub(raypos, raydir, tminmax, primpos, primrot, primscale, template, **_):
    n, h, w = raypos.shape[:3]
    z = (primpos.sum() + primrot.sum() + primscale.sum() + template.sum()) * 0.0
    return z + torch.zeros((n, h, w, 4), device=raypos.device)


def _meta_batch(dims: dict, n: int, h: int, w: int) -> Dict[str, torch.Tensor]:
    m, v = dims["uv_res"], dims["nverts"]
    e = torch.empty
    return {"camrot": e(n, 3, 3), "campos": e(n, 3), "focal": e(n, 2), "princpt": e(n, 2),
            "modelmatrix": e(n, 4, 4), "avgtex": e(n, m, m, 3), "verts": e(n, v, 3),
            "neut_avgtex": e(n, m, m, 3), "neut_verts": e(n, v, 3), "pixelcoords": e(n, h, w, 2),
            "idindex": torch.zeros(n, dtype=torch.int64),
            "camindex": torch.zeros(n, dtype=torch.int64), "image": e(n, h, w, 3)}


def _meta_model(dims: dict) -> Autoencoder:
    m, v = dims["uv_res"], dims["nverts"]
    uv = {"uv_idx": torch.zeros(3, m, m, dtype=torch.int64), "uv_bary": torch.empty(3, m, m),
          "vert_coords": torch.empty(v, 1, 2)}
    return Autoencoder(dims, uv=uv, vertmean=torch.empty(v, 3))


class _GridSampleBytes(TorchDispatchMode):
    """Bytes each grid-sample call must move: its inputs read once and its
    outputs written once, forward and backward (only the gradients asked
    for)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in ("grid_sampler_2d", "grid_sampler_2d_backward"):
            ins = [a for a in args if isinstance(a, torch.Tensor)]
            outs = out if isinstance(out, (tuple, list)) else (out,)
            self.bytes += sum(t.numel() * t.element_size() for t in ins)
            self.bytes += sum(t.numel() * t.element_size() for t in outs
                              if isinstance(t, torch.Tensor))
        return out


def counts(dims: dict, n: int, h: int, w: int, backward: bool) -> Dict[str, float]:
    """Model operations and grid-sample bytes of one forward (and its
    backward) of a batch of n at h x w rays."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        model = _meta_model(dims)
        batch = _meta_batch(dims, n, h, w)
        noise = torch.empty(n, 4, 4, 16)
        gs = _GridSampleBytes()
        with FlopCounterMode(display=False) as fc, gs:
            out = model(batch, noise=noise if backward else None, march_fn=_march_stub)
            if backward:
                loss = out["irgbrec"].sum() + out["verts"].sum() + out["expr_mu"].sum()
                loss.backward()
    return {"flops": float(fc.get_total_flops()), "grid_sample_bytes": float(gs.bytes)}
