# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The port test files' share of the machine's cores.

Under pytest-xdist (``-n N``) every worker imports every test file. Each
worker's torch intra-op pool would size itself to the machine (the port's
files used to cap it at 4): N workers then run several times as many
threads as there are cores, and an OpenMP region waits at its barrier for
its slowest thread, which the kernel has descheduled, at every one of the
thousands of small ops of a plain march. Every ``tests/test_torch_*.py`` of
the port imports this module before its tests run; it gives torch
``THREADS`` = cores // N threads (at least 1, at most ``MAX_THREADS``, so
a file run alone keeps 4; an ``OMP_NUM_THREADS`` set by hand lowers it) and
sets ``OMP_NUM_THREADS`` to it, so that the processes a test starts (the
loader's process pool, the entry points run as children) take the same
share, and caps numpy's BLAS pool in this process the same way
(``threadpoolctl``, where it is installed). XLA's CPU client has no thread
count to set: it sizes its pool to the larger of the cores and the 8 host
devices that ``tests/conftest.py`` forces, and ``XLA_FLAGS=
--xla_cpu_multi_thread_eigen=false`` leaves a large matmul spread over 8
threads in this jaxlib. ``tests/test_torch_port_threads.py`` checks the cap
in its worker.
"""

import os

import torch

MAX_THREADS = 4


def share(cores: int, workers: int) -> int:
    """Threads for one of ``workers`` processes on ``cores`` cores."""
    return max(1, min(MAX_THREADS, cores // max(1, workers)))


CORES = len(os.sched_getaffinity(0))
WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
THREADS = share(CORES, WORKERS)
if os.environ.get("OMP_NUM_THREADS", "").isdigit():  # a cap set by hand stays
    THREADS = max(1, min(THREADS, int(os.environ["OMP_NUM_THREADS"])))
torch.set_num_threads(THREADS)
os.environ["OMP_NUM_THREADS"] = str(THREADS)  # for the processes the tests start
try:  # numpy's BLAS pool, loaded before this module (conftest imports numpy)
    from threadpoolctl import threadpool_limits
except ImportError:  # then numpy's BLAS keeps its pool
    BLAS_LIMITS = None
else:
    BLAS_LIMITS = threadpool_limits(limits=THREADS, user_api="blas")
