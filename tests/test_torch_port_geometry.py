# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The port's topology loading (``ava256_tpu_torch.geometry``) against the
JAX package's ``ava256_tpu.geometry`` on the topology ``.obj`` that
``data.synthetic.write_topology_obj`` writes (the synthetic dataset's own
vertices, spherical UVs, Delaunay faces): ``load_obj`` equal,
``create_uv_baridx`` at resolution 64 with ``uv_idx`` exactly equal and
``uv_bary`` within 1e-6, the same cache file name, and a cache written by
either package read by the other."""

import numpy as np
import pytest

from ava256_tpu_torch.data.synthetic import SyntheticDataset, write_topology_obj
from ava256_tpu_torch.geometry import create_uv_baridx, load_obj
from ava256_tpu_torch.geometry.uv import _cache_key

from tests import _torch_port_threads  # noqa: F401
from ava256_tpu.geometry import create_uv_baridx as jax_create_uv_baridx
from ava256_tpu.geometry import load_obj as jax_load_obj
from ava256_tpu.geometry.uv import _cache_key as jax_cache_key


@pytest.fixture(scope="module")
def obj_path(tmp_path_factory):
    return str(write_topology_obj(tmp_path_factory.mktemp("assets") / "face_topology.obj"))


def test_topology_obj_matches_the_dataset(obj_path):
    obj = load_obj(obj_path)
    ds = SyntheticDataset(nident=1, ncams=1, nframes=1, height=4, width=4, texsize=8)
    np.testing.assert_allclose(obj["v"], ds.base_verts, atol=1e-5)
    assert obj["vt"].shape == (ds.nverts, 2) and obj["vi"].shape[1] == 3
    np.testing.assert_array_equal(obj["vi"], obj["vti"])
    assert obj["vi"].min() == 0 and obj["vi"].max() == ds.nverts - 1
    assert len(obj["vi"]) > ds.nverts  # a closed-ish triangulation, ~2 faces per vertex


def test_load_obj_matches_jax(obj_path, tmp_path):
    got, ref = load_obj(obj_path), jax_load_obj(obj_path)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # quads and normals, and an open handle
    quad = tmp_path / "quad.obj"
    quad.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvn 0 0 1\nvt 0 0\nvt 1 1\n"
                    "f 1/1 2/2 3/2 4/1\n")
    with open(quad) as f:
        got = load_obj(f, return_vn=True)
    ref = jax_load_obj(str(quad), return_vn=True)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_create_uv_baridx_matches_jax(obj_path, tmp_path):
    assert _cache_key(obj_path, 64) == jax_cache_key(obj_path, 64)
    got = create_uv_baridx(obj_path, resolution=64, cache_dir=str(tmp_path / "port"))
    ref = jax_create_uv_baridx(obj_path, resolution=64, cache_dir=str(tmp_path / "jax"))
    assert got.keys() == ref.keys()
    np.testing.assert_array_equal(got["uv_idx"], ref["uv_idx"])
    np.testing.assert_allclose(got["uv_bary"], ref["uv_bary"], rtol=0, atol=1e-6)
    for k in ("uv_coord", "uv_tri", "tri"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["uv_idx"].shape == (3, 64, 64) and got["uv_idx"].dtype == np.int32
    np.testing.assert_allclose(got["uv_bary"].sum(0), 1.0, atol=1e-5)
    # each package reads the other's cache file
    again = create_uv_baridx(obj_path, resolution=64, cache_dir=str(tmp_path / "jax"))
    np.testing.assert_array_equal(again["uv_idx"], ref["uv_idx"])
    back = jax_create_uv_baridx(obj_path, resolution=64, cache_dir=str(tmp_path / "port"))
    np.testing.assert_array_equal(back["uv_bary"], got["uv_bary"])


def test_uv_cache_is_never_seen_half_written(obj_path, tmp_path, monkeypatch):
    """The ranks of a process group build the same UV maps into one cache
    directory: while one writes the cache file, another must find either no
    file (and build the maps itself) or the whole of it, never a file that
    is still being written (``EOFError`` in ``np.load``)."""
    from ava256_tpu_torch.geometry import uv

    cache = tmp_path / "cache"
    target = cache / _cache_key(obj_path, 32)
    save = np.savez_compressed
    seen = []

    def savez_watched(file, **arrays):
        # what a reader would find before the arrays are written, and once
        # they are but the file is not yet closed
        seen.append(target.exists())
        save(file, **arrays)
        seen.append(target.exists())

    monkeypatch.setattr(uv.np, "savez_compressed", savez_watched)
    built = create_uv_baridx(obj_path, resolution=32, cache_dir=str(cache))
    assert seen == [False, False]
    assert sorted(p.name for p in cache.iterdir()) == [target.name]  # no temporary left
    monkeypatch.undo()
    read = create_uv_baridx(obj_path, resolution=32, cache_dir=str(cache))
    np.testing.assert_array_equal(read["uv_idx"], built["uv_idx"])
    np.testing.assert_array_equal(read["uv_bary"], built["uv_bary"])
