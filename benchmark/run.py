"""The benchmark of ``ava256_tpu_torch``: runs one cell of ``BENCHMARK.json``
once and prints its result line (``benchmark/harness/cli.py`` says how).

    python3 benchmark/run.py --workload flagship.train --seed 7 --seconds 10 --trace 0
"""

import sys
import time

T0 = time.perf_counter()  # set-up is timed from the start of the process

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark.harness import cli

    sys.exit(cli.main(sys.argv[1:], T0))
