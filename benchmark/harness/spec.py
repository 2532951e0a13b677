"""What a run is made of, found by name: the cell in ``BENCHMARK.json``, its
configuration (``benchmark/configs/<config>.json``), its traffic mix
(``benchmark/traffic/<traffic>.json``), the loop that mix names
(``benchmark/loops/<loop>.py``: ``run(r)``, one run's set-up, window,
traced tail and comparison, and ``readings(r, seeds, controls, faults)``,
the readings its limits are set from), the limits of its comparison
(``benchmark/limits/<cell>.json``) and one reader per per-layer metric
(``benchmark/metrics/<metric>.py``, a function ``read(records)``). A new
cell, configuration, mix, loop or metric is a new file and a new entry; no
file of the harness changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
SPEC_FILE = ROOT / "BENCHMARK.json"


def load_spec() -> dict:
    return json.loads(SPEC_FILE.read_text())


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(spec: dict, cell_: dict) -> dict:
    for c in spec["configs"]:
        if c["name"] == cell_["config"]:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {cell_['config']!r}")


def traffic_of(cell_: dict) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{cell_['traffic']}.json").read_text())


def limits_of(cell_: dict) -> Dict[str, float]:
    return json.loads((BENCH_DIR / "limits" / f"{cell_['name']}.json").read_text())


def metrics_of(spec: dict, cell_: dict, kind: str) -> List[dict]:
    """The cell's end-to-end (``kind="end_to_end"``) or per-layer metrics:
    those that list it, and those with no list whose end-to-end metric it
    reports (per-layer) or that it reports by default (end-to-end)."""
    name = cell_["name"]
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    if kind == "end_to_end":
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def _module(kind: str, name: str) -> ModuleType:
    """``benchmark/<kind>/<name>.py``, executed anew: it binds what it
    imports of the program at this call."""
    path = BENCH_DIR / kind / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> Callable:
    return _module("metrics", metric).read


def loop(name: str) -> ModuleType:
    return _module("loops", name)
