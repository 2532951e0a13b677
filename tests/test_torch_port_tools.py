# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The port's counterparts of ``scripts/traceprof.py`` and
``scripts/fwdprof.py``, and ``flagship_runs``' long recipe, on the CPU:

- ``traceprof``'s aggregator on a hand-written Chrome trace (a forward
  kernel under a package frame and a module scope, a backward kernel linked
  to its forward op by the autograd node's sequence number, a memcpy, an op
  outside the package) prints its known tables exactly;
- ``traceprof`` on a tiny train step (``bench.build``, the kernels' plain
  versions): every conv layer's backward on that layer's ``[bwd]`` line and
  module, at least 0.9 of the host ops' self time on a source line, and
  ``--aggregate-only`` re-reading the trace;
- ``fwdprof`` at a tiny scene: the parts compose to the op's output bit for
  bit, and its JSON keys are the reference script's plus the port's;
- both tools refuse to run without a card unless asked for the CPU;
- ``flagship_runs``' options with a stand-in for ``cli.train``: the
  commands it starts, the kill in the step after ``--kill-after`` and the
  resume from the last checkpoint.

The times a CPU run prints are host times of the plain versions, not the
card's.
"""

import contextlib
import io
import json
import re
import sys
from pathlib import Path

import pytest
import torch

from ava256_tpu_torch import bench, flagship_runs, fwdprof, traceprof

from tests import _torch_port_threads  # noqa: F401

# one 8x8 image and a one-window march: the plain march's Python frames are
# most of a CPU trace
TINY = dict(batch=1, height=8, width=8, nprims=256, texsize=64, primsize=16,
            raymarch_options={"tile": 8, "max_hit": 4, "nbuf": 16, "dt": 16.0})


# ---------------------------------------------------------------------------
# traceprof
# ---------------------------------------------------------------------------


def _x(cat, name, ts, dur, tid=1, **args):
    return dict(ph="X", cat=cat, name=name, pid=1, tid=tid, ts=float(ts), dur=float(dur),
                args=args)


HAND_TRACE = [
    # the forward, on thread 1: a package frame, a module scope, a conv op
    _x("python_function", "/src/repo/ava256_tpu_torch/traceprof.py(300): profile_step", 0,
       1_000_000),
    _x("python_function", "/src/repo/ava256_tpu_torch/models/enc.py(40): forward", 0, 200_000),
    _x("user_annotation", "module:enc.conv", 5_000, 190_000),
    _x("cpu_op", "aten::conv2d", 10_000, 50_000, **{"Sequence number": 7, "Fwd thread id": 0}),
    _x("cpu_op", "aten::convolution", 11_000, 48_000, **{"Sequence number": 7}),
    _x("cuda_runtime", "cudaLaunchKernel", 12_000, 5_000, correlation=1),
    _x("cpu_op", "aten::copy_", 58_000, 10_000),
    _x("cuda_runtime", "cudaMemcpyAsync", 60_000, 2_000, correlation=3),
    # an op outside any frame of the package
    _x("cpu_op", "aten::mul", 300_000, 10_000),
    _x("cuda_runtime", "cudaLaunchKernel", 301_000, 1_000, correlation=4),
    # the backward, on the autograd engine's thread 2
    _x("cpu_op", "autograd::engine::evaluate_function: ConvolutionBackward0", 400_000, 100_000,
       tid=2, **{"Sequence number": 7, "Fwd thread id": 1}),
    _x("cpu_op", "ConvolutionBackward0", 401_000, 98_000, tid=2,
       **{"Sequence number": 7, "Fwd thread id": 1}),
    _x("cpu_op", "aten::convolution_backward", 402_000, 90_000, tid=2),
    _x("cuda_runtime", "cudaLaunchKernel", 405_000, 5_000, tid=2, correlation=2),
    # the device
    _x("kernel", "implicit_convolve_sgemm", 20_000, 40_000, tid=7, correlation=1),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 70_000, 20_000, tid=8, correlation=3),
    _x("kernel", "elementwise_mul", 310_000, 10_000, tid=7, correlation=4),
    _x("kernel", "sm80_xmma_wgrad_implicit_gemm", 410_000, 30_000, tid=7, correlation=2),
]

HAND_TABLES = """\
total device time: 0.1000s
=== by source line ===
  0.0600s x2     ava256_tpu_torch/models/enc.py(40): forward
  0.0300s x1     [bwd] ava256_tpu_torch/models/enc.py(40): forward
=== unattributed: 0.0100s, top ops ===
  0.0100s aten::mul
=== by module ===
  0.0600s enc.conv
  0.0300s [bwd] enc.conv
  0.0100s (no module)
=== kernels named *wgrad*: 0.0300s, by module ===
  0.0300s [bwd] enc.conv
"""


def test_aggregator_gives_the_known_tables(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": HAND_TRACE}))
    out = io.StringIO()
    rep = traceprof.aggregate(path, 40, "NVIDIA H100 80GB HBM3, 700.00 W", out=out)
    text = out.getvalue()
    assert text.splitlines()[:-1] == HAND_TABLES.splitlines()
    assert json.loads(text.splitlines()[-1]) == rep
    assert rep["total_device_s"] == 0.1 and rep["attributed_share"] == pytest.approx(0.9)
    assert rep["top_lines"][1] == ["[bwd] ava256_tpu_torch/models/enc.py(40): forward", 0.03]
    assert rep["conv_grad_kernels"]["wgrad"]["modules"] == [["[bwd] enc.conv", 0.03]]
    assert rep["conv_grad_kernels"]["dgrad"] == {"s": 0, "lines": [], "modules": []}
    assert rep["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"


def test_traceprof_attributes_a_cpu_step(tmp_path):
    path = traceprof.profile_step("cpu", tmp_path, **TINY)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert traceprof.main(["--aggregate-only", "--trace-dir", str(tmp_path)]) == 0
    lines = out.getvalue().splitlines()
    rep = json.loads(lines[-1])
    assert lines[0].startswith("total cpu self time (host ops, not device time): ")
    assert "total_device_s" not in rep and rep["total_cpu_self_s"] > 0
    assert rep["attributed_share"] >= 0.9 and rep["device"] == "cpu"

    # every conv layer's backward: on that layer's [bwd] line and module
    model = bench.build(device="cpu", **TINY)[0]
    classes = {name: type(m).__name__ for name, m in model.named_modules()}
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    ctx = traceprof._contexts(events)
    resolve = traceprof._resolver(events, ctx)
    nodes = [e for e in events if e["name"] == traceprof.EVALUATE + "ConvolutionBackward0"]
    assert len(nodes) >= 20
    for e in nodes:
        frame, module, bwd = resolve(ctx[id(e)])
        assert bwd and frame.startswith("ava256_tpu_torch/ops/layers.py("), frame
        assert "Conv" in classes[module], (module, classes[module])


def test_fwdprof_parts_compose_to_the_op(capsys):
    argv = ["--device", "cpu", "--batch", "1", "--hw", "8x8", "--nprims", "256", "--tile",
            "8", "--max-hit", "8", "--steps", "1"]
    assert fwdprof.main(argv) == 0
    rep = json.loads(capsys.readouterr().out.splitlines()[-1])
    reference = set(re.findall(r'rep\["(\w+)"\]', Path("scripts/fwdprof.py").read_text()))
    assert reference == {"cull_s", "flatten_s", "scal_gather_s", "kernel_s", "untile_s",
                         "whole_fwd_s", "sum_parts_s", "candidates"}
    assert set(rep) == reference | {"kernel_no_state_s", "bitwise_equal", "steps", "device"}
    assert rep["bitwise_equal"] is True and rep["device"] == "cpu" and rep["candidates"] > 0
    assert rep["sum_parts_s"] == pytest.approx(
        sum(rep[k] for k in ("cull_s", "flatten_s", "scal_gather_s", "kernel_no_state_s",
                             "untile_s")))
    with pytest.raises(SystemExit):
        fwdprof.main(argv + ["--rows", "8"])
    assert "--rows shapes the TPU kernel" in capsys.readouterr().err


@pytest.mark.parametrize("tool,argv", [(traceprof, []), (fwdprof, []),
                                       (traceprof, ["--dtype", "bfloat16"])])
def test_tools_need_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if tool is traceprof:
        argv = argv + ["--trace-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv)


# ---------------------------------------------------------------------------
# flagship_runs
# ---------------------------------------------------------------------------

# A stand-in for ``cli.train``: the loop's order (a checkpoint, named by the
# state's step, is saved before the step's log line), its resume from the
# latest checkpoint and its log format, one step every 250 ms (the kill comes
# 100 ms after the logged step).
FAKE_TRAIN = """
import re, sys, time
from pathlib import Path
opts = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
out = Path(opts["progress.output_path"]) / "checkpoints"
out.mkdir(parents=True, exist_ok=True)
steps = [int(re.findall(r"\\d+", p.name)[0]) for p in out.glob("step_*.pt")]
start, every, bump = max(steps, default=0), int(opts["train.checkpoint_every"]), 8
for i in range(start, int(opts["train.maxiter"])):
    if i % every == 0 and i > 0:
        (out / f"step_{i + 1:08d}.pt").touch()
    lr = 2.8e-4 if i >= int(opts.get("train.lr_scheduler_iter", 10000)) else 2e-4
    print(f"INFO:train:Iteration {i} loss = {100.0 / (i + 1):.4f}, lr = {lr:.2e}, "
          "time: 0.250 s", flush=True)
    time.sleep(0.25)
(out / f"step_{int(opts['train.maxiter']):08d}.pt").touch()
"""


def test_long_recipe_kills_and_resumes(tmp_path, monkeypatch, capsys):
    started = []
    real_start = flagship_runs._start

    def fake_start(cmd, log, env):
        started.append(cmd)
        return real_start([sys.executable, "-c", FAKE_TRAIN] + cmd[cmd.index("--device") + 2:],
                          log, env)

    monkeypatch.setattr(flagship_runs, "_start", fake_start)
    argv = [str(tmp_path), "--device", "cpu", "--arms", "bf16-resume", "--steps", "12",
            "--kill-after", "10", "--checkpoint-every", "4", "train.lr_scheduler_iter=8",
            "data.synthetic_texsize=64"]
    assert flagship_runs.main(argv) == 0
    printed = capsys.readouterr().out
    assert "bf16-resume: SIGKILL after 11 logged steps; relaunched" in printed
    assert "no pair of bf16 runs to compare" in printed
    assert len(started) == 2 and started[0] == started[1]
    cmd = started[0]
    assert cmd[1:5] == ["-m", "ava256_tpu_torch.cli.train", "--config", flagship_runs.CONFIG]
    for opt in ("train.maxiter=12", "train.checkpoint_every=4", "model.dtype=bfloat16",
                "train.lr_scheduler_iter=8", f"progress.output_path={tmp_path / 'bf16-resume'}"):
        assert opt in cmd, opt
    log = (tmp_path / "bf16-resume" / "train.log").read_text()
    steps = [int(s) for s in re.findall(r"Iteration (\d+) loss", log)]
    # steps 0-10 before the kill; the resume from the checkpoint after step
    # 8 runs 9 and 10 again, then 11
    assert steps == list(range(11)) + [9, 10, 11]
    assert log.count("lr = 2.80e-04") == 6


def test_long_recipe_defaults_and_refusals(tmp_path):
    assert (flagship_runs.STEPS, flagship_runs.KILL_AFTER,
            flagship_runs.CHECKPOINT_EVERY) == (600, 466, 100)
    cmd = flagship_runs._command(tmp_path, "bf16", "cuda", [], 600, 100)
    assert cmd[-3:] == ["train.maxiter=600", "train.checkpoint_every=100",
                        "model.dtype=bfloat16"]
    assert flagship_runs._arms("bf16-resume,fp32") == ["fp32", "bf16-resume"]
    for argv in (["--kill-after", "599"], ["--checkpoint-every", "500"], ["--arms", "fp16"]):
        with pytest.raises(SystemExit):
            flagship_runs.main([str(tmp_path)] + argv)
