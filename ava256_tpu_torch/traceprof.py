# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Per-op device-time profile of the flagship train step, attributed to model
code: the port of ``scripts/traceprof.py``.

    python -m ava256_tpu_torch.traceprof [--batch 4] [--hw 512x334]
        [--nprims 16384] [--trace-dir DIR] [--top 40] [--aggregate-only]
        [--device cuda] [--dtype float32|bfloat16]

Builds the model as ``python -m ava256_tpu_torch.bench`` does
(``bench.build``, 1024^2 textures), takes the training warm-up step
(``running_avg_scale``, ground-truth geometry, residuals off) and one normal
step, then traces one more normal step with ``torch.profiler`` (host and
card, Python stacks) into ``DIR/trace.json``; ``--aggregate-only`` re-reads
that file. Every module of the model gets a ``module:<qualified name>``
scope in the trace, opened and closed by forward hooks that the tool
registers for the traced step only (the model's code is not touched).

Each device event (kernel, memcpy, memset) is tied to the CUDA runtime call
that launched it (its correlation id) and so to the innermost host op
enclosing that call on its thread. The op's source line is the innermost
Python frame of the package (``ava256_tpu_torch/...py(line): function``;
the line is where the function starts, as the profiler records a call) that
encloses it. An op that runs inside the autograd engine
(``autograd::engine::evaluate_function: ...``) is backward work and is
tagged ``[bwd]``: a Python frame of the package inside that scope (an
``autograd.Function``'s backward, an activation checkpoint's recompute)
names its line; otherwise the node's sequence number leads to the forward op
that recorded it, and that op's line and module are the backward op's. The
module is the innermost ``module:`` scope, found the same way.

Prints the reference's tables (``total device time``, ``=== by source line
===``, ``=== unattributed ... top ops ===``), then ``=== by module ===`` and
the conv-gradient kernels (names with ``wgrad`` or ``dgrad``) by module,
and last one JSON line: ``total_device_s``, ``attributed_share`` (of the
device time, to a source line), the top rows and ``device`` (the card's
name and power limit from nvidia-smi). On the CPU (``--device cpu``, the
plain versions of the kernels) the tool ranks each host op's self time
instead and calls it ``cpu_self_s``; it is not device time. Without a card
``--device cuda`` fails: there is no fallback.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

TRACE_FILE = "trace.json"
META_FILE = "traceprof.json"  # the traced run's device line and settings
PACKAGE = "ava256_tpu_torch/"
TOOL = PACKAGE + "traceprof.py"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SCOPE_CATS = ("cpu_op", "python_function", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
EVALUATE = "autograd::engine::evaluate_function: "
BACKWARD_NODE = re.compile(r"Backward\d*$")
CONV_GRAD_KERNELS = ("wgrad", "dgrad")  # cuDNN's weight and data gradient kernels
EPS = 1e-3  # us: the trace's timestamps carry three decimals


def _frame(e: dict) -> Optional[str]:
    """``ava256_tpu_torch/...py(line): function`` of a package frame (this
    tool's own frames aside), else None."""
    name = e["name"]
    i = name.find(PACKAGE)
    if i < 0 or name.startswith(TOOL, i):
        return None
    return name[i:]


class _Ctx:
    """What encloses an event on its thread: the innermost package frame,
    ``module:`` scope, host op and autograd node, and whether the frame and
    the module lie inside that node's scope."""

    __slots__ = ("frame", "module", "op", "node", "frame_in_node", "module_in_node")

    def __init__(self, parent: Optional["_Ctx"] = None):
        for k in self.__slots__:
            setattr(self, k, getattr(parent, k) if parent else None)


def _contexts(events: List[dict]) -> Dict[int, _Ctx]:
    """id(event) -> _Ctx for every host event (scopes and launch calls), by a
    sweep over each thread's events in start order with a stack of the open
    scopes."""
    threads = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in SCOPE_CATS + LAUNCH_CATS:
            threads[(e.get("pid"), e.get("tid"))].append(e)
    ctx: Dict[int, _Ctx] = {}
    for evs in threads.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: List[dict] = []
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) <= e["ts"] + EPS:
                stack.pop()
            c = _Ctx(ctx[id(stack[-1])] if stack else None)
            cat, name = e["cat"], e["name"]
            if cat == "python_function":
                frame = _frame(e)
                if frame:
                    c.frame, c.frame_in_node = frame, c.node is not None
            elif cat == "user_annotation" and name.startswith("module:"):
                c.module, c.module_in_node = name[len("module:"):], c.node is not None
            elif cat == "cpu_op":
                c.op = e
                if name.startswith(EVALUATE):
                    c.node, c.frame_in_node, c.module_in_node = e, False, False
            ctx[id(e)] = c
            if cat in SCOPE_CATS:
                stack.append(e)
    return ctx


def _seq(e: dict) -> Optional[int]:
    return (e.get("args") or {}).get("Sequence number")


def _forward_ops(events: List[dict], ctx: Dict[int, _Ctx]):
    """Sequence number -> the forward ops that recorded it, [(tid, ctx)]: the
    outermost op of each (thread, number), autograd nodes aside."""
    found: Dict[int, dict] = {}
    for e in events:
        if e.get("cat") != "cpu_op" or _seq(e) is None:
            continue
        name = e["name"]
        if name.startswith(EVALUATE) or BACKWARD_NODE.search(name):
            continue
        key = (_seq(e), e.get("tid"))
        if key not in found or e["ts"] < found[key]["ts"]:
            found[key] = e
    fwd = collections.defaultdict(list)
    for (seq, tid), e in found.items():
        fwd[seq].append((tid, ctx[id(e)]))
    return fwd


def _resolver(events: List[dict], ctx: Dict[int, _Ctx]):
    """A function ctx -> (source line or None, module or None, backward?)."""
    fwd = _forward_ops(events, ctx)
    # the node's "Fwd thread id" is the profiler's own thread number: learn
    # which trace thread it is from the numbers that only one thread recorded
    votes = collections.defaultdict(collections.Counter)
    for e in events:
        if e.get("cat") == "cpu_op" and e["name"].startswith(EVALUATE) and _seq(e) is not None:
            cands = fwd.get(_seq(e), [])
            if len(cands) == 1:
                votes[e["args"].get("Fwd thread id")][cands[0][0]] += 1
    thread_of = {k: v.most_common(1)[0][0] for k, v in votes.items()}

    def forward_of(node: dict) -> Optional[_Ctx]:
        cands = fwd.get(_seq(node), [])
        if len(cands) > 1:
            tid = thread_of.get(node["args"].get("Fwd thread id"))
            cands = [c for c in cands if c[0] == tid] or cands[:1]
        return cands[0][1] if cands else None

    def resolve(c: _Ctx):
        if c.node is None:
            return c.frame, c.module, False
        frame = c.frame if c.frame_in_node else None
        module = c.module if c.module_in_node else None
        if frame is None or module is None:
            f = forward_of(c.node)
            if f is not None:
                frame = frame or f.frame
                module = module or f.module
        return frame, module, True

    return resolve


def _host_self_times(events: List[dict]):
    """(op event, its self us) for every host op: its time less that of the
    host ops directly inside it, on its thread."""
    threads = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op":
            threads[(e.get("pid"), e.get("tid"))].append(e)
    out = []
    for evs in threads.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: List[list] = []
        for e in evs:
            while stack and stack[-1][0]["ts"] + stack[-1][0].get("dur", 0) <= e["ts"] + EPS:
                out.append(tuple(stack.pop()))
            if stack:
                stack[-1][1] -= e.get("dur", 0)
            stack.append([e, e.get("dur", 0)])
        out.extend(tuple(s) for s in stack)
    return out


def aggregate(path, top: int = 40, device_line: Optional[str] = None, out=None) -> dict:
    """Read a Chrome trace written by ``profile_step`` and print the tables;
    returns the JSON line's dict. Device events are what is ranked when the
    trace has any (``total_device_s``), host ops' self time otherwise
    (``cpu_self_s``)."""
    out = out or sys.stdout
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"] if e.get("ph") == "X"]
    ctx = _contexts(events)
    resolve = _resolver(events, ctx)
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    units = []  # (seconds, context or None, name of what ran)
    if device:
        metric = "device"
        launch = {(e.get("args") or {}).get("correlation"): e for e in events
                  if e.get("cat") in LAUNCH_CATS}
        for e in device:
            call = launch.get((e.get("args") or {}).get("correlation"))
            units.append((e.get("dur", 0) / 1e6, ctx[id(call)] if call is not None else None,
                          e["name"]))
    else:
        metric = "cpu_self"
        for e, self_us in _host_self_times(events):
            units.append((max(self_us, 0.0) / 1e6, ctx[id(e)], e["name"]))

    by_line, line_n = collections.Counter(), collections.Counter()
    by_module = collections.Counter()
    owners = {k: (collections.Counter(), collections.Counter()) for k in CONV_GRAD_KERNELS}
    nosrc = collections.Counter()
    total = attributed = 0.0
    for secs, c, name in units:
        total += secs
        frame, module, bwd = resolve(c) if c is not None else (None, None, False)
        tag = "[bwd] " if bwd else ""
        op = c.op["name"] if c is not None and c.op is not None else name
        if frame:
            attributed += secs
            by_line[tag + frame] += secs
            line_n[tag + frame] += 1
        else:
            nosrc[op] += secs
        by_module[tag + (module or "(no module)")] += secs
        for k, (lines, modules) in owners.items():
            if k in name:
                lines[tag + (frame or op)] += secs
                modules[tag + (module or "(no module)")] += secs

    label = "device time" if metric == "device" else "cpu self time (host ops, not device time)"
    print(f"total {label}: {total:.4f}s", file=out)
    print("=== by source line ===", file=out)
    for s, d in by_line.most_common(top):
        print(f"{d:8.4f}s x{line_n[s]:<5} {s}", file=out)
    print(f"=== unattributed: {sum(nosrc.values()):.4f}s, top ops ===", file=out)
    for n, d in nosrc.most_common(10):
        print(f"{d:8.4f}s {n[:90]}", file=out)
    print("=== by module ===", file=out)
    for s, d in by_module.most_common(top):
        print(f"{d:8.4f}s {s}", file=out)
    for k, (lines, modules) in owners.items():
        if modules:
            print(f"=== kernels named *{k}*: {sum(modules.values()):.4f}s, by module ===",
                  file=out)
            for s, d in modules.most_common(10):
                print(f"{d:8.4f}s {s}", file=out)

    def rows(counter, n):
        return [[k, round(v, 6)] for k, v in counter.most_common(n)]

    rep = {f"total_{metric}_s": round(total, 6),
           "attributed_share": attributed / total if total else 0.0,
           "top_lines": rows(by_line, top), "top_modules": rows(by_module, top),
           "unattributed_top": rows(nosrc, 10),
           "conv_grad_kernels": {k: {"s": round(sum(m.values()), 6), "lines": rows(ln, 10),
                                     "modules": rows(m, 10)}
                                 for k, (ln, m) in owners.items()},
           "device": device_line}
    print(json.dumps(rep), file=out, flush=True)
    return rep


class ModuleScopes:
    """While entered, every submodule's forward runs inside a
    ``annotate("module:<qualified name>")`` scope, opened by a forward
    pre-hook and closed by a forward hook; the hooks are removed on exit."""

    def __init__(self, model):
        self.model = model
        self.handles = []

    def __enter__(self):
        from ava256_tpu_torch.train.profiling import annotate

        open_scopes: Dict[int, list] = collections.defaultdict(list)

        def pre(name):
            def hook(mod, args):
                scope = annotate(f"module:{name}")
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
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles.clear()


def profile_step(device, trace_dir, batch=4, height=512, width=334, nprims=16384,
                 dtype="float32", texsize=1024, primsize=8, raymarch_options=None) -> Path:
    """Build the model as the bench does and trace one normal train step
    (``trace_step``) into ``trace_dir/trace.json``; returns its path."""
    import torch

    from ava256_tpu_torch import bench
    from ava256_tpu_torch.ops.raymarch_cuda import resolve_device

    device = resolve_device(device)
    model, mb, dataset = bench.build(
        texsize=texsize, nprims=nprims, height=height, width=width, batch=batch, device=device,
        raymarch_options=raymarch_options, primsize=primsize,
        dtype=None if dtype == "float32" else getattr(torch, dtype))
    meta = dict(dtype=dtype, batch=batch, hw=[height, width], nprims=nprims)
    return trace_step(model, mb, dataset, trace_dir, device, meta)


def trace_step(model, mb, dataset, trace_dir, device, meta=None) -> Path:
    """The training warm-up step, one normal step, then one more normal step
    traced with ``torch.profiler`` (Python stacks, the model's module
    scopes) into ``trace_dir/trace.json``, beside ``traceprof.json`` (the
    device line, the loss and ``meta``); returns the trace's path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ava256_tpu_torch import bench
    from ava256_tpu_torch.train.state import TrainState, make_optimizer
    from ava256_tpu_torch.train.step import make_train_step

    optimizer = make_optimizer(model)
    step = make_train_step(model, optimizer, bench.LOSS_WEIGHTS, dataset.vertmean,
                           dataset.vertstd)
    state = TrainState(model, optimizer, 0)
    state, loss, _ = step(state, mb, running_avg_scale=True, use_gt_geo=True,
                          residuals_weight=0.0)
    float(loss)
    state, loss, _ = step(state, mb)
    float(loss)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    trace_dir = Path(trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    with ModuleScopes(model), profile(activities=activities, with_stack=True) as prof:
        state, loss, _ = step(state, mb)
        loss = float(loss)
    if not loss == loss:
        raise RuntimeError(f"the traced step's loss is {loss}")
    path = trace_dir / TRACE_FILE
    prof.export_chrome_trace(str(path))
    (trace_dir / META_FILE).write_text(json.dumps(
        dict(meta or {}, device=bench.device_line(device), loss=loss)))
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--hw", default="512x334")
    ap.add_argument("--nprims", type=int, default=16384)
    ap.add_argument("--trace-dir", default=os.path.join(tempfile.gettempdir(), "torchtrace"))
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--aggregate-only", action="store_true",
                    help="skip running; re-aggregate the trace in --trace-dir")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    args = ap.parse_args(argv)
    trace_dir = Path(args.trace_dir)
    if not args.aggregate_only:
        h, w = map(int, args.hw.split("x"))
        profile_step(args.device, trace_dir, batch=args.batch, height=h, width=w,
                     nprims=args.nprims, dtype=args.dtype)
    path = trace_dir / TRACE_FILE
    if not path.exists():
        raise SystemExit(f"no trace at {path}")
    meta = trace_dir / META_FILE
    device_line = json.loads(meta.read_text())["device"] if meta.exists() else None
    aggregate(path, args.top, device_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
