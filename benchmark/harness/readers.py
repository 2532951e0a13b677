"""The arithmetic of the per-layer metrics, over a traced run's records:
``loop`` ("train" or "render"), ``steps`` and ``window_s`` of the untraced
window, ``events`` (the profiled tail's Chrome trace, one ``bench_unit``
a step or frame), the step marks' ``optimizer_s``, the loader's
``loader_wait_s``, and the yardstick's ``flops_per_unit``,
``peak_flops`` and ``grid_sample_bytes_per_unit``, and ``gpu`` (whether
the run was on the card: a device metric reads nothing from a CPU run).
Each returns None where the run has nothing to read; a share is never made
up as 0."""

from __future__ import annotations

from typing import Optional

from benchmark.harness import trace, yardstick

MODEL_MODULES = ("identity_encoder", "expression_encoder", "bottleneck", "decoder_assembler",
                 "colorcal", "bgmodel")
MARCH_KERNELS = ("mvp_march_fwd_kernel", "mvp_march_bwd_kernel")


def _units(rec) -> int:
    return len(trace.units(rec.get("events") or [])) if rec.get("gpu") else 0


def idle_share(rec, loop: str) -> Optional[float]:
    """The untraced window's idle share: 1 - the device's busy time per unit
    (the union of its activity over the traced tail's units: the profiler
    slows the host's launches, not the kernels) over the window's seconds
    per unit."""
    n = _units(rec)
    if rec.get("loop") != loop or not n or not rec.get("steps"):
        return None
    busy, _, _ = trace.busy_and_gaps(rec["events"])
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / 1e6 / n / (rec["window_s"] / rec["steps"]))


def mfu(rec, loop: str) -> Optional[float]:
    if rec.get("loop") != loop or not rec.get("gpu") or not rec.get("flops_per_unit"):
        return None
    return 100.0 * rec["flops_per_unit"] * rec["steps"] / rec["window_s"] / rec["peak_flops"]


def module_ms(rec, loop: str, modules) -> Optional[float]:
    n = _units(rec)
    if rec.get("loop") != loop or not n:
        return None
    by = trace.seconds_by_module(rec["events"])
    s = sum(by.get(m, 0.0) for m in modules)
    return 1e3 * s / n if s > 0 else None


def kernel_ms(rec, loop: str, names) -> Optional[float]:
    n = _units(rec)
    if rec.get("loop") != loop or not n:
        return None
    s = trace.kernel_seconds(rec["events"], names)
    return 1e3 * s / n if s > 0 else None


def grid_sample_roofline(rec, loop: str) -> Optional[float]:
    """Least time of the grid-sample calls' bytes at the HBM rate over the
    grid-sample kernels' device time, per step."""
    ms = kernel_ms(rec, loop, rec.get("gs_kernels") or ())
    if ms is None or not rec.get("grid_sample_bytes_per_unit"):
        return None
    least_ms = 1e3 * rec["grid_sample_bytes_per_unit"] / yardstick.HBM_BYTES_PER_S
    return 100.0 * least_ms / ms


def mean_ms(rec, key: str, loop: str) -> Optional[float]:
    vals = rec.get(key)
    if rec.get("loop") != loop or not vals:
        return None
    return 1e3 * sum(vals) / len(vals)
