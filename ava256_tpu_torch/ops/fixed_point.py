# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The order-free sums of the backward kernels (``csrc/fixed_point.cuh``):
the scale each table is summed at, and the device flag an addend out of
range sets.

A kernel adds ``round(v * 2^k)`` into an int64 table with integer atomics,
so any order of the addends gives the same bits, and turns the table back
into float32 as ``float(q) * 2^-k``. ``scale_for`` picks ``2^k`` from a sound
bound B of the sum of |addends| one table can receive: ``k = floor(61 -
log2 B)``, so that no partial sum can leave int64, and each addend is off by
at most ``2^-(k+1)``. It runs on the device, so the kernels take it without
a host sync. A bound that is not finite (a NaN or inf among the inputs)
gives a NaN scale: the kernel then adds nothing and the table reads NaN, as a
float sum would have.

``flag(device)`` is the int32 a kernel sets when an addend could not be
added (its scaled value reached 2^62, or the bound's premise failed).
``check(device)`` reads it and raises ``FixedPointOverflow``; the training
loop calls it where it already moves each step's loss to the host.

``index_add_exact`` is ``index_add_`` with the same bits in any order, for
the sums PyTorch would otherwise make with float atomics or, under the
deterministic mode, with its sorting path (many times slower on the
compacted marcher's gathers).
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

BITS = 61  # the bound times the scale is at most 2^BITS
K_MIN, K_MAX = -126, 126  # 2^k stays a normal float32
# the flag's bits
OUT_OF_RANGE = 1  # a kernel met an addend whose scaled value reached 2^62
NEGATIVE_DENSITY = 2  # the march's bound assumes densities >= 0; one was not

_FLAGS: Dict[torch.device, torch.Tensor] = {}


class FixedPointOverflow(RuntimeError):
    """An addend of a backward kernel's integer sum was out of range."""


def scale_for(bound: torch.Tensor) -> torch.Tensor:
    """float32 2^k with k = clamp(floor(BITS - log2 bound), K_MIN, K_MAX); NaN
    where ``bound`` is not finite. Elementwise, on the bound's device.
    Exact, as ``csrc/fixed_point.cuh`` ``fxp::scale_for`` computes it on the
    device: bound = m 2^e with m in [0.5, 1), so log2 bound is e - 1 when
    m = 0.5 and lies in (e - 1, e) otherwise; a bound of 0 gives K_MAX."""
    bound = bound.double()
    m, e = torch.frexp(bound)
    k = torch.where(m == 0.5, BITS + 1 - e, BITS - e).double()
    k = torch.clamp(torch.where(bound == 0, torch.full_like(k, K_MAX), k), K_MIN, K_MAX)
    scale = torch.exp2(k).float()
    ok = torch.isfinite(bound) & (bound >= 0)
    return torch.where(ok, scale, torch.full_like(scale, float("nan")))


def _key(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def flag(device) -> torch.Tensor:
    """The device's overflow flag, an int32 the kernels OR bits into."""
    key = _key(device)
    if key not in _FLAGS:
        _FLAGS[key] = torch.zeros(1, dtype=torch.int32, device=key)
    return _FLAGS[key]


def check(device=None) -> None:
    """Raise ``FixedPointOverflow`` if a kernel set the flag of ``device``
    (every device when None) since the last check, and clear it. A read of
    the flag syncs with the device's stream."""
    for dev in list(_FLAGS) if device is None else [_key(device)]:
        f = _FLAGS.get(dev)
        if f is None:
            continue
        bits = int(f.item())
        if bits:
            f.zero_()
            why = [w for b, w in ((OUT_OF_RANGE, "a scaled addend reached 2^62"),
                                  (NEGATIVE_DENSITY, "a density was negative, which the march's "
                                   "bound assumes it is not")) if bits & b]
            raise FixedPointOverflow(f"a backward kernel's fixed-point sum on {dev} is not "
                                     f"exact (flag {bits:#x}): {'; '.join(why)}")


@contextlib.contextmanager
def integer_atomics():
    """Lets PyTorch use its atomic path for integer scatter-adds while the
    deterministic mode is on: integer addition is exact and associative, so
    that path gives the same bits in any order. The mode is global: restored
    on exit."""
    on = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    if on:
        torch.use_deterministic_algorithms(False)
    try:
        yield
    finally:
        if on:
            torch.use_deterministic_algorithms(True, warn_only=warn)


def index_add_exact(nrows: int, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``zeros((nrows,) + src.shape[1:]).index_add_(0, index, src)`` with the
    same bits whatever order the adds take: each column of src is scaled by
    2^k from the column's exact sum of |src| (``scale_for``), rounded to
    int64 (ties to even), added as integers and turned back. Each term is off
    by at most 2^-(k+1); no partial sum can leave int64."""
    flat = src.reshape(src.shape[0], -1).float()
    scale = scale_for(flat.double().abs().sum(dim=0))
    q = torch.round(flat * scale).to(torch.int64)
    out = torch.zeros((nrows, flat.shape[1]), dtype=torch.int64, device=src.device)
    with integer_atomics():
        out.index_add_(0, index.reshape(-1), q)
    return (out.to(torch.float32) * (1.0 / scale)).to(src.dtype).reshape(
        (nrows,) + src.shape[1:])
