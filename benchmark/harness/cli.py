"""One run of one cell, as ``benchmark/run.py`` starts it:

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
        [--device cuda|cpu]

It reads the cell from ``BENCHMARK.json`` and its files, runs the cell's
loop (set-up, the measured window, with ``--trace 1`` a profiled tail, then
the reference's comparison) and prints, last on standard output, one JSON
line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
``breakdown`` (traced runs) and ``checks`` (each number compared beside its
limit, also the last lines on standard error).

Without a card, or with fewer cards than the cell asks for, it exits with 2
and prints no result; ``--device cpu`` is the CPU rehearsal at the
configuration's ``rehearsal`` sizes, never a fallback. It exits with 3 and
no result when, after the window, the process holds a module of JAX or of
the JAX package. Every cache (the program's UV maps, the topology, the
reference's UV maps) lies in ``benchmark/cache`` inside the checkout, and a
traced run's Chrome trace in ``benchmark/out/<cell>/``."""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from types import SimpleNamespace

from benchmark.harness import spec as spec_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "ava256_tpu")
CACHE = spec_mod.BENCH_DIR / "cache"


def forbidden_modules(names) -> list:
    """Modules whose top-level name is JAX's or the JAX package's, compared
    whole (the program's own name only begins with the JAX package's)."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def _set_dotted(d: dict, key: str, value) -> None:
    *path, last = key.split(".")
    for p in path:
        d = d.setdefault(p, {})
    d[last] = value


def rehearsal(conf: dict, traffic: dict):
    """The configuration and the mix at their CPU rehearsal sizes."""
    conf, traffic = copy.deepcopy(conf), copy.deepcopy(traffic)
    for k, v in conf.get("rehearsal", {}).items():
        _set_dotted(conf["config"], k, v)
    traffic.update(traffic.get("rehearsal", {}))
    return conf, traffic


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def environment() -> None:
    """The run's environment, set before torch is imported: the caches in
    the checkout, and no JAX behind a library."""
    os.environ["AVA256_CACHE_DIR"] = str(CACHE / "program")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"


def run_of(cell: dict, device: str, seed: int, seconds: float, trace: bool, t0: float):
    """What a loop's ``run`` and ``readings`` take: the cell's configuration
    and mix (at their rehearsal sizes on the CPU), the device and the
    caches."""
    conf, traffic = spec_mod.config_of(spec_mod.load_spec(), cell), spec_mod.traffic_of(cell)
    environment()
    import torch

    dev = torch.device("cuda", 0)
    if device == "cpu":
        conf, traffic = rehearsal(conf, traffic)
        dev = torch.device("cpu")
    return SimpleNamespace(device=dev, conf=conf, traffic=traffic, seed=seed, seconds=seconds,
                           trace=trace, t0=t0, assets=CACHE / "assets",
                           cache_dir=CACHE / "reference",
                           out_dir=spec_mod.BENCH_DIR / "out" / cell["name"])


def main(argv, t0: float) -> int:
    args = parse(argv)
    spec = spec_mod.load_spec()
    cell = spec_mod.cell(spec, args.workload)
    limits = spec_mod.limits_of(cell)
    environment()
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
                  file=sys.stderr)
            return 2
        torch.cuda.set_device(0)
    from benchmark.harness import check, trace

    run = run_of(cell, args.device, args.seed, args.seconds, bool(args.trace), t0)
    device = run.device
    res = spec_mod.loop(run.traffic["loop"]).run(run)

    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"the process holds modules of JAX or of the JAX package: {bad}", file=sys.stderr)
        return 3

    rec = res["records"]
    if args.trace:
        metrics = {}
        for m in spec_mod.metrics_of(spec, cell, "per_layer"):
            v = spec_mod.reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(res["metrics"], setup_s=res["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec_mod.metrics_of(spec, cell, "end_to_end")}
    gpu = device.type == "cuda"
    dev = {"platform": "gpu" if gpu else "cpu",
           "kind": torch.cuda.get_device_name(device) if gpu else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": check.judge(res["numbers"], limits) and len(res["numbers"]) > 0,
            "attempted": res["attempted"], "failed": res["failed"], "metrics": metrics,
            "device": dev}
    if args.trace:
        busy, span, _ = trace.busy_and_gaps(rec["events"])
        dev.update(busy_s=busy / 1e6, window_s=span / 1e6)
        line["breakdown"] = trace.breakdown(rec["events"])
    print(f"setup_s {res['setup_s']:.3f} window_s {rec['window_s']:.3f} units {rec['steps']} "
          f"reference_s {rec['reference_s']:.3f}", file=sys.stderr)
    line["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in res["numbers"].items()}
    for k, v in res["numbers"].items():
        print(f"check {k} {v!r} limit {limits.get(k)!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
