"""The comparison that decides ``correct`` tells the program from its
lower-precision control, on the card at each cell's own size: a sound run
of the program stays under every limit, and the reference computed with
TF32 convolutions and matrix products, put in the program's place, goes
over at least one.

    python -m pytest -m cuda benchmark/tests/test_harness_control.py
"""

import time

import pytest
import torch

from benchmark.harness import check, cli
from benchmark.harness import spec as S

pytestmark = pytest.mark.cuda
SPEC = S.load_spec()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the program's kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_control_fails_where_the_program_passes(card, cell):
    limits = S.limits_of(cell)
    r = cli.run_of(cell, "cuda", 4242, 2.0, False, time.perf_counter())
    rows = {row["kind"]: row for row in S.loop(r.traffic["loop"]).readings(r, [4242], 1, 0)}
    sound, control = ({k: rows[kind][k] for k in limits} for kind in ("sound", "control_tf32"))
    assert check.judge(sound, limits), sound
    assert not check.judge(control, limits), control
