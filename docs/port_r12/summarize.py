# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The numbers of ``docs/port_r12/README.md`` from the files beside it:

- the CPU arms (``cpu*/*.jsonl``: ``cpu`` the long mode at 64x64 rays,
  ``cpu_r128`` at 128x128, ``cpu_tiny`` the tier-1 size): window medians of
  KL and irgbl1, the smallest KL after step 25 and where; how fast J and
  P-J part, beside P-J and its 1-ulp twin;
- the card runs (``card*/**/train.log``): the largest KL of steps 0-39 and
  where, the median KL of steps 40-60, the smallest KL of steps 25-60;
- the 600-step runs beside ``docs/port_r9/`` and the reference's
  (``run-fp32-600/``, ``run-bf16/``): KL, irgbl1 and vertl1 at steps 18,
  30, 100, 500, 599 and the train probe's PSNR at step 500.

    python docs/port_r12/summarize.py
"""

import glob
import json
import os
import re

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
ITERATION = re.compile(r"Iteration (\d+) loss = (\S+), (.*?) (?:lr = |time:)")
PSNR = re.compile(r"Progress iter (\d+): PSNR (\S+) dB")


def log_terms(path):
    """step -> {loss term: value} of a train.log (the first line of a step)."""
    out = {}
    for line in open(path, errors="replace"):
        m = ITERATION.search(line)
        if m and int(m.group(1)) not in out:
            terms = dict(t.split(" = ") for t in m.group(3).rstrip(",").split(", "))
            out[int(m.group(1))] = {k: float(v) for k, v in terms.items()}
    return out


def psnr(path, step):
    for line in open(path, errors="replace"):
        m = PSNR.search(line)
        if m and int(m.group(1)) == step:
            return float(m.group(2))
    return None


def cpu_arms():
    for d in sorted(glob.glob(os.path.join(HERE, "cpu*"))):
        arms = {}
        for path in sorted(glob.glob(os.path.join(d, "*.jsonl"))):
            for line in open(path):
                x = json.loads(line)
                arms.setdefault(x["arm"], {})[x["step"]] = x
        for arm, steps in arms.items():
            last = max(steps)
            windows = [(lo, min(hi, last)) for lo, hi in ((0, 19), (20, 39), (40, 59), (60, 83))
                       if lo <= last]
            med = {f"{lo}-{hi}": [round(float(np.median([steps[i][k] for i in range(lo, hi + 1)])),
                                        4) for k in ("kldiv", "irgbl1")] for lo, hi in windows}
            after = range(25, last + 1)
            low = min(after, key=lambda i: steps[i]["kldiv"]) if last >= 25 else None
            print(json.dumps({"cpu": os.path.basename(d), "arm": arm, "steps": last + 1,
                              "median_kldiv_irgbl1": med,
                              "min_kldiv_after_25": None if low is None else
                              [steps[low]["kldiv"], low],
                              "nonfinite": sum(sum(s["nonfinite"].values())
                                               for s in steps.values())}))


def pairs():
    """How fast two arms part: the median and the largest, over each window,
    of the relative difference of every loss term, for J against P-J, and
    P-J against its 1-ulp twins (the rounding's own pace)."""
    for d in sorted(glob.glob(os.path.join(HERE, "cpu*"))):
        arms = {}
        for path in sorted(glob.glob(os.path.join(d, "*.jsonl"))):
            for line in open(path):
                x = json.loads(line)
                arms.setdefault(x["arm"], {})[x["step"]] = x
        for a, b in (("J", "P-J"), ("P-J", "P-J-ulp"), ("P-J", "P-J-ulps")):
            if a not in arms or b not in arms:
                continue
            last = min(max(arms[a]), max(arms[b]))
            out = {}
            for lo, hi in ((0, 9), (10, 19), (20, 39), (40, 59)):
                if lo > last:
                    continue
                steps = range(lo, min(hi, last) + 1)
                out[f"{lo}-{min(hi, last)}"] = {
                    k: [f(rel) for f in (np.median, np.max)]
                    for k in ("kldiv", "irgbl1", "vertl1", "primvolsum")
                    for rel in [[abs(arms[a][i][k] - arms[b][i][k]) / abs(arms[a][i][k])
                                 for i in steps]]}
            print(json.dumps({"cpu": os.path.basename(d), "pair": [a, b],
                              "rel_diff_median_max": out}, default=float))


def card_runs():
    for path in sorted(glob.glob(os.path.join(HERE, "card*", "**", "train.log"),
                                 recursive=True)):
        kl = {i: t["kldiv"] for i, t in log_terms(path).items()}
        top = max(range(40), key=kl.get)
        print(json.dumps({"run": os.path.relpath(os.path.dirname(path), HERE),
                          "largest_kldiv_0_39": [kl[top], top],
                          "median_kldiv_40_60": float(np.median([kl[i] for i in range(40, 61)])),
                          "smallest_kldiv_25_60": min(kl[i] for i in range(25, 61))}))


def six_hundred():
    runs = {"port fp32": os.path.join(HERE, "card/flagship/fp32/train.log"),
            "port bf16": os.path.join(HERE, "card/flagship/bf16/train.log"),
            "port_r9 fp32": os.path.join(ROOT, "docs/port_r9/fp32/train.log"),
            "port_r9 bf16": os.path.join(ROOT, "docs/port_r9/bf16/train.log"),
            "reference fp32": os.path.join(ROOT, "run-fp32-600/train.log"),
            "reference bf16": os.path.join(ROOT, "run-bf16/train.log")}
    for name, path in runs.items():
        terms = log_terms(path)
        print(json.dumps({"run": name, **{f"@{i}": {k: terms[i][k] for k in
                                                     ("kldiv", "irgbl1", "vertl1")}
                                            for i in (18, 30, 100, 500, 599)},
                          "psnr@500": psnr(path, 500)}))


if __name__ == "__main__":
    cpu_arms()
    pairs()
    card_runs()
    six_hundred()
