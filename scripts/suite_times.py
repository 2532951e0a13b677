#!/usr/bin/env python3
# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Per-file seconds of a pytest run, from its ``--junitxml`` file: the sum
of each file's testcase times (setup, call and teardown, so module fixtures
count where their first test runs), its test count and passes, longest
first, as a markdown table. With two files, both columns side by side (for
example the parent tree's run and the change's).

    python scripts/suite_times.py /tmp/_t1.xml [--top 10]
    python scripts/suite_times.py BEFORE.xml AFTER.xml [--top 10]
"""

from __future__ import annotations

import argparse
import xml.etree.ElementTree as ET
from collections import defaultdict


def per_file(path: str) -> dict:
    """{file: [seconds, tests, passed]} of a junit XML file."""
    out = defaultdict(lambda: [0.0, 0, 0])
    for case in ET.parse(path).getroot().iter("testcase"):
        name = case.get("file") or case.get("classname", "").split(".")[1] + ".py"
        row = out[name.split("/")[-1]]
        row[0] += float(case.get("time") or 0.0)
        row[1] += 1
        row[2] += not any(c.tag in ("failure", "error", "skipped") for c in case)
    return dict(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("xml", nargs="+", help="one or two junit XML files")
    ap.add_argument("--top", type=int, default=0, help="only the longest N files (0: all)")
    args = ap.parse_args(argv)
    runs = [per_file(p) for p in args.xml]
    files = sorted(set().union(*runs), key=lambda f: -max(r.get(f, [0])[0] for r in runs))
    if args.top:
        files = files[:args.top]
    cols = " | ".join(f"s ({i + 1}) | passed/tests ({i + 1})" for i in range(len(runs)))
    print(f"| file | {cols} |")
    print("|---" * (1 + 2 * len(runs)) + "|")
    for f in files:
        cells = " | ".join(f"{r[f][0]:.1f} | {r[f][2]}/{r[f][1]}" if f in r else "- | -"
                           for r in runs)
        print(f"| `{f}` | {cells} |")
    for i, r in enumerate(runs):
        print(f"({i + 1}) {args.xml[i]}: {sum(v[0] for v in r.values()):.1f} s of testcase "
              f"time, {sum(v[2] for v in r.values())} passed of {sum(v[1] for v in r.values())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
