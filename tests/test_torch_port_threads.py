# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The port test files' thread cap (``tests/_torch_port_threads.py``) in
the worker that runs this file: torch's intra-op pool has the worker's
share of the cores, an op that could spread over every core runs on at most
that many threads, a process a test starts takes the same share, and an
``OMP_NUM_THREADS`` set by hand lowers it."""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from tests import _torch_port_threads as cap

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("cores,workers,threads", [
    (8, 6, 1), (8, 4, 2), (8, 3, 2), (8, 2, 4), (8, 1, 4), (2, 1, 2), (1, 1, 1), (64, 6, 4)])
def test_share(cores, workers, threads):
    assert cap.share(cores, workers) == threads


def test_a_cap_set_by_hand_stays():
    code = "from tests import _torch_port_threads; import torch; print(torch.get_num_threads())"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTEST_XDIST_WORKER_COUNT="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=120, check=True).stdout.split()
    assert out == ["1"]


def test_the_worker_runs_torch_on_its_share():
    assert cap.WORKERS == int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert cap.THREADS == cap.share(len(os.sched_getaffinity(0)), cap.WORKERS)
    assert torch.get_num_threads() == cap.THREADS
    assert f"at::get_num_threads() : {cap.THREADS}" in torch.__config__.parallel_info()


def _busy_threads(fn) -> int:
    """How many of this process's threads took CPU time while ``fn`` ran."""
    def ticks():
        out = {}
        for t in os.listdir("/proc/self/task"):
            try:
                f = Path(f"/proc/self/task/{t}/stat").read_text().rsplit(")", 1)[1].split()
            except OSError:  # the thread ended
                continue
            out[t] = int(f[11]) + int(f[12])
        return out

    before = ticks()
    fn()
    after = ticks()
    return sum(after[t] > before.get(t, 0) for t in after)


def test_numpy_blas_runs_on_the_share():
    """numpy's BLAS, and any other loaded since (scipy's, which reads
    ``OMP_NUM_THREADS`` when it loads)."""
    threadpoolctl = pytest.importorskip("threadpoolctl")
    assert cap.BLAS_LIMITS is not None
    blas = [i for i in threadpoolctl.threadpool_info() if i["user_api"] == "blas"]
    assert any("numpy" in i["filepath"] for i in blas), blas
    assert {i["num_threads"] for i in blas} == {cap.THREADS}, blas


def test_a_parallel_op_stays_on_the_share():
    """A large elementwise op (torch splits it over its pool) keeps at most
    the share's threads busy, this one included (and one more, for a thread
    of the test harness that may wake meanwhile); torch's whole pool would
    keep every core's thread busy."""
    x = torch.rand(1 << 22)
    me = threading.get_native_id()
    assert Path(f"/proc/self/task/{me}").exists()
    t0 = time.perf_counter()
    busy = _busy_threads(lambda: [torch.exp(x).sum() for _ in range(60)])
    assert time.perf_counter() - t0 < 60
    assert 1 <= busy <= cap.THREADS + 1, (busy, cap.THREADS)


def test_a_started_process_takes_the_same_share():
    """A child process, whether it imports the cap or only torch."""
    assert os.environ["OMP_NUM_THREADS"] == str(cap.THREADS)
    for code in ("import torch; from tests import _torch_port_threads as c; "
                 "print(c.THREADS, torch.get_num_threads())",
                 "import torch; print(torch.get_num_threads())"):
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             cwd=ROOT, timeout=120, check=True).stdout.split()
        assert out and set(out) == {str(cap.THREADS)}, (code, out)
