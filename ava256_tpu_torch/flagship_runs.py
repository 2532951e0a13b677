# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The flagship convergence runs, float32 against bfloat16, and a bfloat16 run
killed mid-step and resumed, as the JAX package's ``docs/dtype_r5.md`` and
``docs/convergence_r5.md`` ran them:

    python -m ava256_tpu_torch.flagship_runs OUT [--device cuda] [--steps 600]
        [--kill-after 466] [--checkpoint-every 100] [--arms fp32,bf16,bf16-resume]
        [OVERRIDES...]

One ``python -m ava256_tpu_torch.cli.train --config
configs/config-synthetic-flagship.yaml assets=OUT/assets
train.maxiter=STEPS train.checkpoint_every=EVERY`` run per arm, side by
side on one card, each logging to ``OUT/<arm>/train.log``:

- ``fp32``: as configured;
- ``bf16``: with ``model.dtype=bfloat16``;
- ``bf16-resume``: the bf16 command, killed with SIGKILL in step KILL + 1,
  once step KILL has logged its loss, then launched again unchanged: it
  resumes from its last checkpoint and runs the steps after it up to KILL
  once more, appending to the same log (``scripts/resume_check.py`` pairs
  them).

The defaults are the 600-step recipe (kill after step 466, a checkpoint
every 100 steps: the resume re-runs 401-466). The reference's round-5 run
(``docs/convergence_r5.md``) is ``--arms bf16-resume --steps 4400
--kill-after 4166 --checkpoint-every 2000 train.lr_scheduler_iter=4000``:
one bf16 run across the StepLR bump at 4,000, killed after step 4,166 and
resumed from the step-4,000 checkpoint.

The topology is ``data.synthetic.write_topology_obj``'s, the UV maps are
built once into ``OUT/cache`` before the runs start. The runs share the card,
so their step times are not the port's speed (``chip_smoke.py``'s
``[dtype-turns]`` times the two dtypes); their losses and PSNR probes are
what the runs are for. A training step repeats bit for bit, so the resumed
run must end where the uninterrupted one does: with both ``bf16`` and
``bf16-resume`` among the arms, their last checkpoints are compared entry by
entry and the result printed (without ``bf16`` there is nothing to compare
with: the re-logged losses, ``scripts/resume_check.py``, are the check).
Exits non-zero if a run fails, the kill did not land in step KILL + 1 or the
two checkpoints differ.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

CONFIG = "configs/config-synthetic-flagship.yaml"
ARMS = {"fp32": [], "bf16": ["model.dtype=bfloat16"],
        "bf16-resume": ["model.dtype=bfloat16"]}
STEPS, KILL_AFTER, CHECKPOINT_EVERY = 600, 466, 100  # the 600-step recipe


def _command(out: Path, arm: str, device: str, opts: list, steps: int,
             checkpoint_every: int) -> list:
    return [sys.executable, "-m", "ava256_tpu_torch.cli.train", "--config", CONFIG,
            "--device", device, f"assets={out / 'assets'}", f"progress.output_path={out / arm}",
            f"train.maxiter={steps}", f"train.checkpoint_every={checkpoint_every}"] \
        + ARMS[arm] + opts


def compare_checkpoints(a: Path, b: Path) -> list:
    """The entries (parameters, optimizer state, step) in which two
    ``torch.save`` checkpoints differ, bit for bit; empty when equal."""
    import torch

    def leaves(x, key=()):
        if isinstance(x, dict):
            return {k: v for name in x for k, v in leaves(x[name], key + (name,)).items()}
        if isinstance(x, (list, tuple)):
            return {k: v for i, item in enumerate(x) for k, v in leaves(item, key + (i,)).items()}
        return {key: x}

    la, lb = (leaves(torch.load(p, map_location="cpu", weights_only=True)) for p in (a, b))
    differ = sorted(str(k) for k in set(la) ^ set(lb))
    for k in set(la) & set(lb):
        x, y = la[k], lb[k]
        same = (x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
                if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
                else type(x) is type(y) and x == y)
        if not same:
            differ.append(str(k))
    return differ


def _start(cmd: list, log: Path, env: dict) -> subprocess.Popen:
    with open(log, "a") as fh:
        return subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT, env=env)


def _arms(text: str) -> list:
    arms = [a for a in text.split(",") if a]
    unknown = sorted(set(arms) - set(ARMS))
    if not arms or unknown:
        raise argparse.ArgumentTypeError(f"arms are a comma list of {', '.join(ARMS)}; "
                                         f"got {text!r}")
    return [a for a in ARMS if a in arms]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", type=Path)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS, help="train.maxiter of every arm")
    ap.add_argument("--kill-after", type=int, default=KILL_AFTER,
                    help="bf16-resume is killed in the step after this one")
    ap.add_argument("--checkpoint-every", type=int, default=CHECKPOINT_EVERY)
    ap.add_argument("--arms", type=_arms, default=list(ARMS),
                    help="comma list of fp32, bf16, bf16-resume")
    ap.add_argument("opts", nargs="*", help="more dotted overrides for every run")
    args = ap.parse_intermixed_args(argv)  # overrides may follow the options
    resume = "bf16-resume" in args.arms
    if resume and not 0 < args.checkpoint_every <= args.kill_after < args.steps - 1:
        ap.error("the kill needs a checkpoint before it and a step after it: "
                 "0 < --checkpoint-every <= --kill-after < --steps - 1")
    out = args.out.resolve()
    env = dict(os.environ, AVA256_CACHE_DIR=str(out / "cache"))
    os.environ["AVA256_CACHE_DIR"] = env["AVA256_CACHE_DIR"]

    from ava256_tpu_torch.config import load_config
    from ava256_tpu_torch.data.synthetic import write_topology_obj
    from ava256_tpu_torch.train.loop import load_uvdata

    write_topology_obj(out / "assets" / "face_topology.obj")
    load_uvdata(load_config(CONFIG, [f"assets={out / 'assets'}"] + args.opts))
    procs, cmds = {}, {}
    for arm in args.arms:
        (out / arm).mkdir(parents=True, exist_ok=True)
        cmds[arm] = _command(out, arm, args.device, args.opts, args.steps, args.checkpoint_every)
        procs[arm] = _start(cmds[arm], out / arm / "train.log", env)

    killed_at = None
    if resume:
        # the kill: in the step after --kill-after, once its loss line is written
        log = out / "bf16-resume" / "train.log"
        mark = f"Iteration {args.kill_after} loss ="
        while mark not in log.read_text(errors="replace"):
            if procs["bf16-resume"].poll() is not None:
                print(f"bf16-resume ended (rc {procs['bf16-resume'].returncode}) before step "
                      f"{args.kill_after}", file=sys.stderr)
                for p in procs.values():
                    p.kill()
                    p.wait()
                return 1
            time.sleep(0.02)
        time.sleep(0.1)
        procs["bf16-resume"].send_signal(signal.SIGKILL)
        procs["bf16-resume"].wait()
        killed_at = log.read_text(errors="replace").count("Iteration ")
        print(f"bf16-resume: SIGKILL after {killed_at} logged steps; relaunched", flush=True)
        procs["bf16-resume"] = _start(cmds["bf16-resume"], log, env)

    rcs = {arm: p.wait() for arm, p in procs.items()}
    print(f"runs ended: {rcs}", flush=True)
    if resume and killed_at != args.kill_after + 1:
        print(f"the kill landed after {killed_at} logged steps, not in step "
              f"{args.kill_after + 1}", file=sys.stderr)
        return 1
    if any(rcs.values()):
        return 1
    if not (resume and "bf16" in args.arms):
        print("no pair of bf16 runs to compare checkpoints of"
              + ("; the re-logged losses (scripts/resume_check.py) are the resume's check"
                 if resume else ""), flush=True)
        return 0
    final = [out / arm / "checkpoints" / f"step_{args.steps:08d}.pt"
             for arm in ("bf16", "bf16-resume")]
    differ = compare_checkpoints(*final)
    print(f"step-{args.steps} checkpoints of bf16 and bf16-resume: "
          + ("bitwise equal" if not differ else f"{len(differ)} entries differ: {differ[:8]}"),
          flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
