"""The traced tail of a run and its reduction: a few steps or frames under
``torch.profiler`` (host and device activity), each inside a
``bench_unit`` annotation, every submodule of the model inside a
``module:<name>`` scope and the march inside ``module:raymarcher``; then,
from the Chrome trace, the device's busy union and its idle gaps with the
host op running in the middle of each, the device time by kernel name, and
the device time by the top-level module that launched it.

The gap and module arithmetic are frozen copies of the program's tools
(``chip_smoke.trace_busy``, ``traceprof``'s contexts and resolver): an
operation run inside the autograd engine is charged to the module of the
forward operation that recorded it (the node's sequence number)."""

from __future__ import annotations

import collections
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SCOPE_CATS = ("cpu_op", "python_function", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
EVALUATE = "autograd::engine::evaluate_function: "
UNIT = "bench_unit"
EPS = 1e-3


class _RaymarcherScope:
    """Stands in for the model's raymarcher (an object, not a module): each
    call runs inside a ``module:raymarcher`` scope, and so does the backward
    of the march's autograd node (its third output's, the RGBA), opened and
    closed by hooks on that node."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, *args, **kwargs):
        from torch.profiler import record_function

        with record_function("module:raymarcher"):
            out = self.inner(*args, **kwargs)
        node = out[2].grad_fn
        if node is not None:
            scopes = []

            def pre(grad_outputs):
                scopes.append(record_function("module:raymarcher").__enter__())

            def post(grad_inputs, grad_outputs):
                if scopes:
                    scopes.pop().__exit__(None, None, None)

            node.register_prehook(pre)
            node.register_hook(post)
        return out


class ModuleScopes:
    """While entered, every submodule's forward runs inside a
    ``module:<qualified name>`` scope (forward hooks, removed on exit), and
    the raymarcher inside ``module:raymarcher``."""

    def __init__(self, model):
        self.model, self.handles, self.marcher = model, [], None

    def __enter__(self):
        from torch.profiler import record_function

        open_scopes = collections.defaultdict(list)

        def pre(name):
            def hook(mod, args):
                scope = record_function(f"module:{name}")
                scope.__enter__()
                open_scopes[id(mod)].append(scope)
            return hook

        def post(mod, args, output):
            if open_scopes[id(mod)]:
                open_scopes[id(mod)].pop().__exit__(None, None, None)

        for name, mod in self.model.named_modules():
            if name:
                self.handles.append(mod.register_forward_pre_hook(pre(name)))
                self.handles.append(mod.register_forward_hook(post, always_call=True))
        self.marcher = getattr(self.model, "raymarcher", None)
        if self.marcher is not None:
            self.model.raymarcher = _RaymarcherScope(self.marcher)
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles.clear()
        if self.marcher is not None:
            self.model.raymarcher = self.marcher


def profile(unit: Callable[[], None], count: int, model, path: Path) -> List[dict]:
    """Run ``unit`` ``count`` times under the profiler; write the Chrome
    trace to ``path`` and return its complete events."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with ModuleScopes(model):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(count):
                with record_function(UNIT):
                    unit()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]


def units(events: List[dict]) -> List[Tuple[float, float]]:
    """(start, end) in us of each traced unit."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("name") == UNIT and e.get("cat") == "user_annotation")


def device_events(events: List[dict]) -> List[dict]:
    return sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])


def busy_and_gaps(events: List[dict]) -> Tuple[float, float, List[Tuple[float, float]]]:
    """Over the traced units' span: (busy us, span us, idle gaps [(start,
    end)]): the union of device activity, and the gaps between it."""
    spans = units(events)
    if not spans:
        return 0.0, 0.0, []
    t0, t1 = spans[0][0], spans[-1][1]
    gaps, busy_to, busy = [], t0, 0.0
    for e in device_events(events):
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b <= a:
            continue
        if a > busy_to:
            gaps.append((busy_to, a))
        if b > busy_to:
            busy += b - max(a, busy_to)
            busy_to = b
    if t1 > busy_to:
        gaps.append((busy_to, t1))
    return busy, t1 - t0, gaps


def host_op_at(events: List[dict], t: float) -> str:
    """The innermost host op running at time t (what the host was doing)."""
    live = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime")
            and e["ts"] <= t < e["ts"] + e["dur"]]
    return min(live, key=lambda e: e["dur"])["name"] if live else "python"


def kernel_seconds(events: List[dict], names) -> float:
    """Device seconds of the kernels whose name contains one of ``names``,
    inside the traced units."""
    spans = units(events)
    if not spans:
        return 0.0
    t0, t1 = spans[0][0], spans[-1][1]
    return sum(e["dur"] for e in device_events(events) if e["cat"] == "kernel"
               and t0 <= e["ts"] < t1 and any(n in e["name"] for n in names)) / 1e6


def breakdown(events: List[dict], top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle gaps
    by the host op in their middle, in seconds."""
    spans = units(events)
    t0, t1 = (spans[0][0], spans[-1][1]) if spans else (0.0, 0.0)
    ops = collections.Counter()
    for e in device_events(events):
        if t0 <= e["ts"] < t1:
            ops[e["name"][:120]] += e["dur"] / 1e6
    _, _, gaps = busy_and_gaps(events)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
            "idle_gaps": [[host_op_at(events, (a + b) / 2), (b - a) / 1e6] for a, b in longest]}


# --- device time by module (the program's traceprof, frozen) ---------------


class _Ctx:
    __slots__ = ("module", "op", "node", "module_in_node")

    def __init__(self, parent: Optional["_Ctx"] = None):
        for k in self.__slots__:
            setattr(self, k, getattr(parent, k) if parent else None)


def _contexts(events):
    threads = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in SCOPE_CATS + LAUNCH_CATS:
            threads[(e.get("pid"), e.get("tid"))].append(e)
    ctx = {}
    for evs in threads.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack = []
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) <= e["ts"] + EPS:
                stack.pop()
            c = _Ctx(ctx[id(stack[-1])] if stack else None)
            cat, name = e["cat"], e["name"]
            if cat == "user_annotation" and name.startswith("module:"):
                c.module, c.module_in_node = name[len("module:"):], c.node is not None
            elif cat == "cpu_op":
                c.op = e
                if name.startswith(EVALUATE):
                    c.node, c.module_in_node = e, False
            ctx[id(e)] = c
            if cat in SCOPE_CATS:
                stack.append(e)
    return ctx


def _seq(e):
    return (e.get("args") or {}).get("Sequence number")


def _resolver(events, ctx):
    found = {}
    for e in events:
        if e.get("cat") != "cpu_op" or _seq(e) is None:
            continue
        if e["name"].startswith(EVALUATE) or e["name"].rstrip("0123456789").endswith("Backward"):
            continue
        key = (_seq(e), e.get("tid"))
        if key not in found or e["ts"] < found[key]["ts"]:
            found[key] = e
    fwd = collections.defaultdict(list)
    for (seq, tid), e in found.items():
        fwd[seq].append((tid, ctx[id(e)]))
    votes = collections.defaultdict(collections.Counter)
    for e in events:
        if e.get("cat") == "cpu_op" and e["name"].startswith(EVALUATE) and _seq(e) is not None:
            cands = fwd.get(_seq(e), [])
            if len(cands) == 1:
                votes[e["args"].get("Fwd thread id")][cands[0][0]] += 1
    thread_of = {k: v.most_common(1)[0][0] for k, v in votes.items()}

    def resolve(c: _Ctx) -> Optional[str]:
        if c.node is None:
            return c.module
        if c.module_in_node and c.module:
            return c.module
        cands = fwd.get(_seq(c.node), [])
        if len(cands) > 1:
            tid = thread_of.get(c.node["args"].get("Fwd thread id"))
            cands = [x for x in cands if x[0] == tid] or cands[:1]
        return cands[0][1].module if cands else None

    return resolve


def seconds_by_module(events: List[dict]) -> Dict[str, float]:
    """Device seconds inside the traced units by the top-level module (the
    first part of its qualified name) whose scope launched them, backward
    work included; "" for work outside every module."""
    spans = units(events)
    if not spans:
        return {}
    t0, t1 = spans[0][0], spans[-1][1]
    ctx = _contexts(events)
    resolve = _resolver(events, ctx)
    launch = {(e.get("args") or {}).get("correlation"): e for e in events
              if e.get("cat") in LAUNCH_CATS}
    out = collections.Counter()
    for e in device_events(events):
        if not t0 <= e["ts"] < t1:
            continue
        call = launch.get((e.get("args") or {}).get("correlation"))
        module = resolve(ctx[id(call)]) if call is not None else None
        out[(module or "").split(".")[0]] += e.get("dur", 0) / 1e6
    return dict(out)
