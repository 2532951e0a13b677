# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""What the expression encoder sees on the synthetic flagship data, for two
topologies at the flagship's 1024^2 UV resolution:

- ``delaunay``: ``write_topology_obj``'s mesh (the Delaunay triangulation of
  the vertices' spherical UVs), the topology of every port run;
- ``fallback``: the JAX suite's stand-in when ``face_topology.obj`` is
  absent (``__graft_entry__._uvdata``: random vertex triples, barycentrics
  1/3 everywhere).

Printed as one JSON object: the share of the texels that lie inside a
triangle of the UV mesh (the rest take the closest triangle's edge), and,
over the frames of identity 0, the per-texel spread (std over frames) of
``geo_img = generate_geomap(verts - neut_verts)``, the input of the
encoder's geometry branch (``models/encoders/expression.py``), its mean
|value|, and the same spread of the normalized vertices themselves. The
texture branch sees the identity's texture in every frame (``avgtex`` is
``neut_avgtex`` in ``SyntheticDataset``): geometry is the only per-frame
signal.

    python docs/port_r12/encoder_inputs.py [--resolution 1024] [--frames 8 32]
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch
from scipy.spatial import Delaunay

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from ava256_tpu_torch.data.synthetic import SyntheticDataset, write_topology_obj  # noqa: E402
from ava256_tpu_torch.geometry import create_uv_baridx, load_obj  # noqa: E402
from ava256_tpu_torch.ops.geomap import generate_geomap  # noqa: E402


def fallback_uvdata(resolution: int, nv: int = 7306):
    rng = np.random.RandomState(0)
    return {"uv_idx": rng.randint(0, nv, size=(3, resolution, resolution)).astype(np.int32),
            "uv_bary": np.full((3, resolution, resolution), 1.0 / 3.0, np.float32)}


def coverage(vt: np.ndarray, resolution: int) -> float:
    """Share of texel centres inside the Delaunay triangulation of ``vt``
    (the delaunay topology's faces are exactly that triangulation)."""
    c = (np.arange(resolution) + 0.5) / resolution
    u, v = np.meshgrid(c, c)
    pts = np.stack([u.ravel(), v.ravel()], axis=-1)
    return float(np.mean(Delaunay(vt).find_simplex(pts) >= 0))


def spread(uv, frames: int, resolution: int) -> dict:
    ds = SyntheticDataset(nident=4, ncams=4, nframes=frames, height=8, width=8,
                          texsize=resolution)
    neut = ds._norm_neut_verts[0]
    geo = np.stack([(ds._verts(0, f) - ds.vertmean) / ds.vertstd - neut for f in range(frames)])
    img = generate_geomap(torch.from_numpy(geo.astype(np.float32)),
                          torch.from_numpy(uv["uv_idx"].astype(np.int64)),
                          torch.from_numpy(uv["uv_bary"])).numpy().astype(np.float64)
    return {"geo_img_std_over_frames": float(img.std(axis=0).mean()),
            "geo_img_mean_abs": float(np.abs(img).mean()),
            "verts_std_over_frames": float(geo.std(axis=0).mean())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--resolution", type=int, default=1024)
    ap.add_argument("--frames", type=int, nargs="+", default=[8, 32])
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        obj = write_topology_obj(os.path.join(tmp, "face_topology.obj"))
        delaunay = create_uv_baridx(str(obj), resolution=args.resolution, cache_dir=tmp)
        vt = load_obj(str(obj))["vt"]
        out = {"resolution": args.resolution,
               "delaunay": {"texels_inside_a_triangle": coverage(vt, args.resolution)},
               "fallback": {"texels_inside_a_triangle": None,
                            "note": "every texel takes the centroid of a random vertex triple"}}
        for f in args.frames:
            out["delaunay"][f"frames_{f}"] = spread(delaunay, f, args.resolution)
            out["fallback"][f"frames_{f}"] = spread(fallback_uvdata(args.resolution), f,
                                                    args.resolution)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
