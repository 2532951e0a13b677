# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The port's data path (``ava256_tpu_torch.data``) against the JAX
package's ``ava256_tpu.data`` on the CPU: equal values.

- the synthetic dataset's ``get_allcameras``, ``get_img_size`` and
  ``item_camindex`` (missing from the port before), and its items;
- ``CameraSplit`` and ``last_n_camindices``: the same index lists;
- ``ShardedLoader``: the same batches, arrays equal, with shuffle on and
  off, two hosts, a resume by ``set_position``, ``drop_last=False`` and the
  process pool;
- ``device_prefetch`` keeps order, skips ``None``, raises a feeder error in
  the consumer and stops its thread (and the loader's workers) when the
  consumer leaves early.
"""

import threading
import time

import numpy as np
import pytest
import torch

from ava256_tpu_torch.data import (
    CameraSplit, ShardedLoader, SyntheticDataset, device_prefetch, last_n_camindices)
from ava256_tpu_torch.data.loader import Uploader

from tests import _torch_port_threads  # noqa: F401
from ava256_tpu.data.dataset import CameraSplit as JaxCameraSplit
from ava256_tpu.data.dataset import last_n_camindices as jax_last_n_camindices
from ava256_tpu.data.loader import ShardedLoader as JaxShardedLoader
from ava256_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset

SMALL = dict(nident=2, ncams=5, nframes=3, height=12, width=10, texsize=16)


@pytest.fixture(scope="module")
def datasets():
    return SyntheticDataset(**SMALL), JaxSyntheticDataset(**SMALL)


def _equal_batches(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is None:
            continue
        assert g.keys() == r.keys()
        for k in r:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(r[k]), err_msg=k)


def test_synthetic_dataset_methods_match_jax(datasets):
    ds, jds = datasets
    assert ds.get_allcameras() == jds.get_allcameras() == list(range(SMALL["ncams"]))
    assert ds.get_img_size() == jds.get_img_size() == (SMALL["height"], SMALL["width"])
    assert [ds.item_camindex(i) for i in range(len(ds))] == \
        [jds.item_camindex(i) for i in range(len(jds))]
    assert [ds.item_camindex(i) for i in range(len(ds))] == \
        [int(ds[i]["camindex"]) for i in range(len(ds))]
    _equal_batches([ds[i] for i in (0, 7, len(ds) - 1)], [jds[i] for i in (0, 7, len(ds) - 1)])


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("heldout", [False, True])
def test_camera_split_matches_jax(datasets, n, heldout):
    ds, jds = datasets
    cams = last_n_camindices(ds, n)
    assert cams == jax_last_n_camindices(jds, n) == list(range(SMALL["ncams"] - n, SMALL["ncams"]))
    split, jsplit = CameraSplit(ds, cams, heldout), JaxCameraSplit(jds, cams, heldout)
    assert split._indices == jsplit._indices and len(split) == len(jsplit)
    assert {int(split[i]["camindex"]) in cams for i in range(len(split))} == {heldout}
    assert split.get_allcameras() == ds.get_allcameras()  # forwarded to the base
    for bad in (0, SMALL["ncams"]):
        with pytest.raises(ValueError):
            last_n_camindices(ds, bad)


LOADER_CASES = {
    "shuffle": dict(shuffle=True),
    "no_shuffle": dict(shuffle=False),
    "host0_of_2": dict(host_id=0, num_hosts=2),
    "host1_of_2": dict(host_id=1, num_hosts=2, seed=3),
    "keep_last": dict(drop_last=False, batch_size=4),
    "one_worker_small_window": dict(num_workers=1, prefetch=1),
}


def _take(loader, epochs, position=None):
    if position is not None:
        loader.set_position(position)
    return [b for _ in range(epochs) for b in loader]


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_sharded_loader_matches_jax(datasets, case):
    ds, jds = datasets
    kw = dict(dict(batch_size=3, num_workers=3), **LOADER_CASES[case])
    got = _take(ShardedLoader(ds, **kw), 2)
    ref = _take(JaxShardedLoader(jds, **kw), 2)
    _equal_batches(got, ref)
    assert len(got) == 2 * len(ShardedLoader(ds, **kw))
    # a resume at a global batch index replays the uninterrupted sequence
    per = len(ShardedLoader(ds, **kw))
    for position in (1, per + 2):
        resumed = _take(ShardedLoader(ds, **kw), 1, position)
        _equal_batches(resumed, _take(JaxShardedLoader(jds, **kw), 1, position))
        _equal_batches(resumed, got[position:position + len(resumed)])


def test_sharded_loader_process_pool_matches_jax(datasets):
    ds, jds = datasets
    loader = ShardedLoader(ds, batch_size=4, num_workers=2, use_processes=True)
    jloader = JaxShardedLoader(jds, batch_size=4, num_workers=2, use_processes=True)
    try:
        loader.set_position(3)
        jloader.set_position(3)
        _equal_batches(list(loader), list(jloader))
    finally:
        loader.close()
        jloader._pool.terminate()


def test_sharded_loader_drops_failed_items():
    class Holes:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return None if i < 4 else {"i": np.array(i)}

    batches = list(ShardedLoader(Holes(), batch_size=2, shuffle=False))
    assert batches[:2] == [None, None] and [b["i"].tolist() for b in batches[2:]] == [[4, 5],
                                                                                      [6, 7]]


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "device_prefetch"]


def _wait_gone(threads, timeout=5.0):
    deadline = time.time() + timeout
    while any(t.is_alive() for t in threads) and time.time() < deadline:
        time.sleep(0.02)
    return not any(t.is_alive() for t in threads)


def test_device_prefetch_order_none_and_errors():
    items = [1, None, 2, 3, None, 4]
    assert list(device_prefetch(items, lambda x: x * 10, depth=1)) == [10, 20, 30, 40]

    def broken():
        yield 1
        raise OSError("disk gone")

    got = []
    with pytest.raises(OSError, match="disk gone"):
        for x in device_prefetch(broken(), lambda x: x):
            got.append(x)
    assert got == [1]
    with pytest.raises(ZeroDivisionError):
        list(device_prefetch([1, 0], lambda x: 1 // x))
    assert _wait_gone(_prefetch_threads())


def test_device_prefetch_stops_when_abandoned(datasets):
    ds, _ = datasets
    before = set(threading.enumerate())
    loader = ShardedLoader(ds, batch_size=2, num_workers=3, prefetch=2)
    gen = device_prefetch(loader, Uploader("cpu"), depth=1)
    first = next(gen)
    assert isinstance(first["image"], torch.Tensor)
    gen.close()  # the train loop breaking at maxiter
    started = [t for t in threading.enumerate() if t not in before]
    assert started and _wait_gone(started), [t.name for t in started if t.is_alive()]


def test_uploader_on_cpu_gives_equal_tensors(datasets):
    ds, _ = datasets
    batch = next(iter(ShardedLoader(ds, batch_size=2, shuffle=False)))
    up = Uploader("cpu")(batch)
    assert up.keys() == batch.keys()
    for k, v in batch.items():
        np.testing.assert_array_equal(up[k].numpy(), np.asarray(v))
