"""Readings that the limits of ``correct`` are set from, taken on the card
at a cell's own size, in one process:

    python3 benchmark/calibrate.py --workload flagship.render --seeds 101,102,... \\
        [--control 3] [--faults 3] [--out FILE]

The cell's loop (``benchmark/loops/<loop>.py``, its ``readings``) gives,
for each seed, the numbers of a sound run (the program's checked steps or
frames against the reference); for the first ``--control`` seeds the
control's (the reference computed with TF32 convolutions and matrix
products in the program's place, against the float32 reference); for the
first ``--faults`` seeds the numbers of runs with a fault planted in the
program. One JSON line per reading goes to standard output and to
``--out``."""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.harness import cli  # noqa: E402
from benchmark.harness import spec as S  # noqa: E402


def emit(out, **row):
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    cell = S.cell(S.load_spec(), a.workload)
    r = cli.run_of(cell, a.device, 0, a.seconds, False, time.perf_counter())
    seeds = [int(s) for s in a.seeds.split(",")]
    for row in S.loop(r.traffic["loop"]).readings(r, seeds, a.control, a.faults):
        emit(a.out, **row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
