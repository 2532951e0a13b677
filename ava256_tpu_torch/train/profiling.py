# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Tracing and per-step timing, as ``ava256_tpu.train.profiling``: a step
timer with percentile summaries written as ``timesinfo_r{rank}.npy``, a
``torch.profiler`` trace of a region written as a Chrome trace, and named
regions in that trace (recorded only while a profiler runs)."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
from torch.autograd import profiler as autograd_profiler

TRACE_FILE = "trace.json"  # the Chrome trace ``trace`` writes into its logdir


class StepTimer:
    """Accumulates per-step wall times and writes timesinfo summaries. The
    caller ends the timed block after the step's result is on the host."""

    def __init__(self) -> None:
        self.times: List[float] = []
        self.start_time = time.time()

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        t0 = time.time()
        yield
        self.times.append(time.time() - t0)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"steps": 0, "totaltime": time.time() - self.start_time}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "totaltime": time.time() - self.start_time,
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "p99_s": float(np.percentile(arr, 99)),
            "steps_per_sec": float(1.0 / max(np.median(arr), 1e-9)),
        }

    def save(self, outpath: str, rank: int = 0) -> None:
        info = self.summary()
        info["maxiter"] = len(self.times)
        np.save(Path(outpath) / f"timesinfo_r{rank}", info, allow_pickle=True)


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (host and, where there is a
    card, device activity) into ``logdir/trace.json``; a no-op if None."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    Path(logdir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(logdir) / TRACE_FILE))


def recording() -> bool:
    """Whether a profiler records: the flag ``annotate`` reads, for counts
    that are taken only while a trace is being made."""
    return autograd_profiler._is_profiler_enabled


class annotate:
    """A named region in the timeline of a running ``torch.profiler``: a
    ``record_function`` opened only while a profiler records, so that
    outside one a region costs one flag read. The port's only span
    function."""

    __slots__ = ("name", "_scope")

    def __init__(self, name: str) -> None:
        self.name, self._scope = name, None

    def __enter__(self) -> None:
        if autograd_profiler._is_profiler_enabled:
            self._scope = autograd_profiler.record_function(self.name)
            self._scope.__enter__()

    def __exit__(self, *exc) -> None:
        if self._scope is not None:
            self._scope.__exit__(*exc)
            self._scope = None
