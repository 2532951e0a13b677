# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The forward march op split into its parts, timed one by one: the port of
``scripts/fwdprof.py``.

    python -m ava256_tpu_torch.fwdprof [--batch 4] [--hw 512x334]
        [--nprims 16384] [--tile 16] [--max-hit 64] [--steps 5] [--device cuda]

``mvp_raymarch_cuda`` (``ops/raymarch_cuda.py``) is: cull -> the template
table handed to the kernel -> the candidates' affines -> the kernel ->
untile. On ``kbench``'s seeded shell scene (its rays cut at nbuf step rows
as the op cuts them) this times each part alone on operands computed before
(``kbench.time_calls``: a warm-up call, then the mean of ``--steps`` calls
between CUDA events on the card):

- ``cull_s``: ``tile_and_cull``;
- ``flatten_s``: the ``[N*K, bs, bs, bs, 4]`` contiguous template the op
  hands the kernel (a view when the template is contiguous already);
- ``scal_gather_s``: ``candidate_affines`` and the int32 cast of the
  candidates' box indices;
- ``kernel_s``: ``march_tiles`` with the rays' state, as a training step
  asks for it; ``kernel_no_state_s`` without it, as a render does;
- ``untile_s``: ``untile``;

and the whole op under ``torch.no_grad()`` (``whole_fwd_s``, which runs the
kernel without the state). ``sum_parts_s`` adds the five parts as that call
runs them (``kernel_no_state_s``). Prints one JSON line with the reference
script's keys and the port's (``kernel_no_state_s``, ``bitwise_equal``,
``steps``, ``device``: the card's name and power limit). The parts composed
must give the whole op's RGBA bit for bit (with and without the state):
exits 1 if they do not.

``--rows`` shaped the TPU kernel and has no counterpart here: anything but its
default is refused. Without a card ``--device cuda`` fails (no fallback);
``--device cpu`` runs the kernels' plain versions, and its times are host
times.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ava256_tpu_torch import kbench
from ava256_tpu_torch.bench import device_line
from ava256_tpu_torch.ops import raymarch_cuda as rc

TPU_ONLY_FLAGS = {"rows": 4}  # the JAX script's, with its default


def profile(device, batch=4, h=512, w=334, nprims=16384, tile=16, max_hit=64, steps=5,
            boxsize=8, seed=0) -> dict:
    """The parts' and the whole op's seconds on the shell scene, and whether
    the composed parts give the op's output bit for bit."""
    device = rc.resolve_device(device)
    s = kbench.make_flagship_scene(batch, h, w, nprims, boxsize=boxsize, seed=seed)
    t = kbench.scene_tensors(s, device)
    rp, rd, tmm, pp, pr, ps, tpl = (t[k] for k in kbench.SCENE_KEYS)
    n, K = pp.shape[:2]
    bs = tpl.shape[2]
    dt = float(s["stepsize"])
    nbuf = rc.default_nbuf(dt)
    fade = dict(fadescale=8.0, fadeexp=8.0)
    rep = {}

    def timed(key, fn):
        rep[key] = kbench.time_calls(fn, steps, device)
        return fn()

    with torch.no_grad():
        # the op's own cut of the rays at nbuf step rows
        tmm_c = torch.stack([tmm[..., 0], torch.minimum(tmm[..., 1], tmm[..., 0] + nbuf * dt)],
                            dim=-1)
        pm = torch.ones((n, K), dtype=torch.float32, device=device)
        t_o, t_d, t_mm, gid, valid, _, meta = timed(
            "cull_s", lambda: rc.tile_and_cull(rp, rd, tmm_c, pp, ps, pm, tile, max_hit, dt))
        flat = timed("flatten_s", lambda: tpl.reshape(n * K, bs, bs, bs, 4).contiguous())
        scal, gid32 = timed("scal_gather_s", lambda: (
            rc.candidate_affines(pp, pr, ps, gid, valid), gid.to(torch.int32).contiguous()))
        march = (gid32, scal, t_o, t_d, t_mm, flat, None, dt, fade["fadescale"],
                 fade["fadeexp"], nbuf)
        out_state, _ = timed("kernel_s", lambda: rc.march_tiles(*march, with_state=True))
        out = timed("kernel_no_state_s", lambda: rc.march_tiles(*march))
        img = timed("untile_s", lambda: rc.untile(out, meta, tile))
        whole = timed("whole_fwd_s", lambda: rc.mvp_raymarch_cuda(
            rp, rd, dt, tmm, pp, pr, ps, tpl, None, tile=tile, max_hit=max_hit, device=device,
            **fade))
    rep["sum_parts_s"] = (rep["cull_s"] + rep["flatten_s"] + rep["scal_gather_s"]
                          + rep["kernel_no_state_s"] + rep["untile_s"])
    rep["candidates"] = int(valid.sum())
    rep["bitwise_equal"] = bool(torch.equal(img, whole)
                                and torch.equal(rc.untile(out_state, meta, tile), whole))
    rep["steps"] = steps
    rep["device"] = device_line(device)
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--hw", default="512x334")
    ap.add_argument("--nprims", type=int, default=16384)
    ap.add_argument("--tile", type=int, default=16)
    ap.add_argument("--max-hit", type=int, default=64)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=TPU_ONLY_FLAGS["rows"])
    args = ap.parse_args(argv)
    if args.rows != TPU_ONLY_FLAGS["rows"]:
        ap.error(f"--rows shapes the TPU kernel and has no counterpart in the port's CUDA "
                 f"kernels; leave it at {TPU_ONLY_FLAGS['rows']}")
    h, w = map(int, args.hw.split("x"))
    rep = profile(args.device, args.batch, h, w, args.nprims, args.tile, args.max_hit,
                  args.steps)
    print(json.dumps(rep), flush=True)
    if not rep["bitwise_equal"]:
        print("fwdprof: the composed parts differ from the whole op's output", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
