# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Times and lane use of the CUDA raymarch kernels on the flagship scene.

    python3 scripts/march_kernel_probe.py [--rounds N] [--out FILE]

Needs one NVIDIA card. On the scene ``chip_smoke.py`` renders (batch 4,
512x334 rays, 16,384 primitives of 8^3, tile 16, max_hit 64, nbuf 896) it
times, ``--rounds`` times over so that the spread inside the call shows, the
forward kernel without and with its state output and the backward kernel with
and without the forward's state (each the mean of ``REPS`` launches by CUDA
events). Then it runs the counting instances of both kernels once and prints
their lane use, ``useful samples / (32 x warp trips)``: a warp trip is one
execution of ``eval_sample`` by a warp with any lane active; the counter also
sums ``__popc(__activemask())`` over the trips (lanes that entered). Every
result is one JSON line, the registers and spills of the build (``ptxas``)
among them, and the whole a JSON file (default
``ava256_tpu_torch/_build/march_kernel_probe.json``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ava256_tpu_torch.ops import raymarch_cuda as rc  # noqa: E402
from ava256_tpu_torch.ops.cuda_lib import BUILD_DIR, build_all  # noqa: E402

REPS = 5


def lane_use(trips: int, lanes: int, useful: int) -> dict:
    return dict(warp_trips=trips, lanes_entered=lanes, useful_samples=useful,
                lane_use=useful / (32.0 * trips) if trips else None,
                entered_share=lanes / (32.0 * trips) if trips else None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path, default=BUILD_DIR / "march_kernel_probe.json")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("march_kernel_probe: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    results: list = []

    def emit(**rec) -> None:
        results.append(rec)
        print(json.dumps(rec), flush=True)

    smi = chip_smoke.nvidia_smi()
    emit(device=torch.cuda.get_device_name(0), smi=smi, reps=REPS)
    libs = [rc.MARCH_FWD_LIB, rc.MARCH_BWD_LIB]
    build_all(libs)
    emit(ptxas=[ln.strip() for lib in libs for ln in lib.build_log.splitlines()
                if "registers" in ln or "spill" in ln])

    mi = chip_smoke.flagship_render(dev)[3]
    args = chip_smoke.flagship_scene_args(mi, dev, chip_smoke.FLAGSHIP["tile"],
                                          chip_smoke.FLAGSHIP["max_hit"])[0]
    gid, scal, t_o, t_d, t_mm, *rest = args
    g = torch.randn((gid.shape[0], 4, t_o.shape[2]), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    fwd, bwd = rc.march_tiles_kernel, rc.march_tiles_bwd_kernel

    with torch.inference_mode():
        _, state = fwd(*args, with_state=True)
        bwd(gid, scal, t_o, t_d, t_mm, g, *rest, state=state)
        for rnd in range(opt.rounds):
            emit(round=rnd,
                 fwd_ms=chip_smoke.cuda_ms(lambda: fwd(*args), REPS),
                 fwd_with_state_ms=chip_smoke.cuda_ms(lambda: fwd(*args, with_state=True), REPS),
                 bwd_ms=chip_smoke.cuda_ms(
                     lambda: bwd(gid, scal, t_o, t_d, t_mm, g, *rest, state=state), REPS),
                 bwd_without_state_ms=chip_smoke.cuda_ms(
                     lambda: bwd(gid, scal, t_o, t_d, t_mm, g, *rest), REPS))
        pf, pb = {}, {}
        fwd(*args, probe=pf)
        bwd(gid, scal, t_o, t_d, t_mm, g, *rest, state=state, probe=pb)
        emit(fwd=lane_use(*pf["march"]), bwd_march=lane_use(*pb["march"]),
             bwd_chain=lane_use(*pb["chain"]))

    opt.out.parent.mkdir(parents=True, exist_ok=True)
    opt.out.write_text(json.dumps(results, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
