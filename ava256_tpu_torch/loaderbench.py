# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Input-pipeline throughput, the port of the JAX package's
``scripts/loaderbench.py``:

    python -m ava256_tpu_torch.loaderbench [--frames 24] [--items 48] [--downsample 8]
        [--workers 1,2,4] [--processes] [--small]

Writes one capture of the synthetic dataset in the ava-256 release's on-disk
layout at the dome's resolution, 4096x2668 (``data.synthetic.write_capture``:
2 cameras, ``--frames`` frames, 1024^2 textures; ``--small``: 512x334), and
measures ``ShardedLoader`` items/s end to end (zip read, PNG inflate and
unfilter, resize by ``--downsample``, PLY, texture) for each worker count,
threads or, with ``--processes``, processes. PNG only: the release's AVIF
needs Pillow with AVIF, which the card host does not have (``--codec avif``
is refused). Prints one JSON line with the JAX script's fields; the flagship
training rate needs batch 4 x steps/s items per host (the reference loads
with 4 worker processes).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

from ava256_tpu_torch.data.dataset import MugsyCapture, SingleCaptureDataset
from ava256_tpu_torch.data.loader import ShardedLoader
from ava256_tpu_torch.data.synthetic import SyntheticDataset, write_capture

FULL_HW, SMALL_HW = (4096, 2668), (512, 334)


def build_fixture(root: Path, n_frames: int, downsample: int, small: bool = False) -> Path:
    """One identity of the synthetic dataset, 2 cameras, ``n_frames`` frames,
    written as a capture under ``root``; returns its ``decoder`` directory."""
    ds = SyntheticDataset(nident=1, ncams=2, nframes=n_frames, height=SMALL_HW[0],
                          width=SMALL_HW[1], texsize=1024)
    hw = SMALL_HW if small else FULL_HW
    write_capture(root, ds, downsample=downsample, image_hw=hw)
    return next(root.glob("*--*--*/decoder"))


def bench(frames: int = 24, items: int = 48, downsample: int = 8, workers=(1, 2, 4),
          processes: bool = False, small: bool = False) -> dict:
    with tempfile.TemporaryDirectory() as td:
        t0 = time.time()
        decoder = build_fixture(Path(td), frames, downsample, small)
        build_s = time.time() - t0
        mcd, mct, sid = decoder.parent.name.split("--")
        ds = SingleCaptureDataset(MugsyCapture(mcd=mcd, mct=mct, sid=sid), str(decoder),
                                  downsample=downsample)
        n = min(items, len(ds))

        # single-thread decode cost
        t0 = time.time()
        for i in range(min(4, n)):
            ds[i]
        per_item_s = (time.time() - t0) / min(4, n)

        results = {}
        for nw in workers:
            loader = ShardedLoader(ds, batch_size=4, shuffle=False, num_workers=nw, host_id=0,
                                   num_hosts=1, use_processes=processes)
            got = 0
            t0 = time.time()
            try:
                for batch in loader:
                    if batch is None:
                        continue
                    got += len(batch["image"])
                    if got >= n:
                        break
            finally:
                loader.close()
            results[f"items_per_s_w{nw}"] = round(got / (time.time() - t0), 2)

    return {
        "source_px": "512x334" if small else "4096x2668",
        "codec": "png",
        "downsample": downsample,
        "workers": "processes" if processes else "threads",
        "single_thread_item_s": round(per_item_s, 3),
        **results,
        "flagship_need_items_per_s": 4 * 0.5,  # batch 4 x ~0.5 steps/s target
        "fixture_build_s": round(build_s, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--items", type=int, default=48)
    ap.add_argument("--downsample", type=int, default=8)
    ap.add_argument("--workers", default="1,2,4")
    ap.add_argument("--processes", action="store_true")
    ap.add_argument("--small", action="store_true", help="512x334 source images")
    ap.add_argument("--codec", choices=["avif", "png"], default="png")
    args = ap.parse_args(argv)
    if args.codec != "png":
        ap.error("--codec avif needs Pillow with AVIF, which the port does not use: png only")
    print(json.dumps(bench(args.frames, args.items, args.downsample,
                           [int(x) for x in args.workers.split(",")], args.processes,
                           args.small)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
