# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Per-host sharded, background-prefetched data loading, as
``ava256_tpu.data.loader``: each host iterates its own shard of a
(optionally shuffled) global index permutation, and workers overlap item
decode with device compute. Failed samples are dropped at collate.

Workers are threads by default; ``use_processes=True`` switches to a spawned
process pool for hosts where Python-side per-item work dominates.

``device_prefetch`` maps an upload over the loader in a feeder thread. On a
CUDA device, ``Uploader`` copies each batch from pinned host memory on a
side stream there, and the consumer's stream waits on that copy's event
before the step reads the batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np

from ava256_tpu_torch.data.dataset import none_collate
from ava256_tpu_torch.train.profiling import annotate

_WORKER_DATASET = None


def _pool_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _pool_fetch(batch_indices):
    return none_collate([_WORKER_DATASET[int(j)] for j in batch_indices])


class Upload:
    """A batch whose host-to-device copy was queued on a side stream.
    ``ready()``, called in the consuming thread, orders the consumer's current
    stream after the copy and returns the batch."""

    def __init__(self, batch: Dict[str, Any], event, device):
        self.batch, self.event, self.device = batch, event, device

    def ready(self) -> Dict[str, Any]:
        import torch

        with annotate("ava:upload"):
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.event)
            for t in self.batch.values():
                # the copies were allocated on the side stream: keep their memory
                # from being reused until the consumer's stream is done with them
                t.record_stream(stream)
        return self.batch


class Uploader:
    """``fn`` for ``device_prefetch``: numpy batch -> tensors on ``device``.
    On CUDA the copy is queued from pinned memory on a side stream and an
    ``Upload`` is returned; on the CPU the tensors themselves."""

    def __init__(self, device):
        import torch

        self.device = torch.device(device)
        self._stream = None

    def __call__(self, batch: Dict[str, Any]):
        import torch

        with annotate("ava:upload"):
            host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
            if self.device.type != "cuda":
                return {k: t.to(self.device) for k, t in host.items()}
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._stream):
                out = {k: t.pin_memory().to(self.device, non_blocking=True)
                       for k, t in host.items()}
                event = torch.cuda.Event()
                event.record(self._stream)
        return Upload(out, event, self.device)

    def now(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """One batch on the device, ready for the caller's stream (no
        prefetch thread: evaluation and rendering)."""
        up = self(batch)
        return up.ready() if isinstance(up, Upload) else up


def device_prefetch(iterable, fn: Callable, depth: int = 2, keep_none: bool = False):
    """Map ``fn`` (typically the host->device upload) over ``iterable`` in a
    background thread so the transfer of batch i+1 overlaps the consumer's
    compute on batch i. ``None`` items (failed collates) are skipped, or
    with ``keep_none`` passed on as ``None`` (ranks that must agree on
    every step need to see them); an
    error in the feeder is raised in the consumer. An ``Upload`` is made
    ``ready()`` in the consumer's thread before it is yielded. When the
    consumer stops early, the feeder stops, closes ``iterable``'s iterator
    and the queued batches are dropped."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    end = object()
    errs = []
    closed = threading.Event()

    def put(item) -> bool:
        # bounded put that gives up if the consumer abandoned the generator
        # (train loop breaking at maxiter): otherwise the feeder would pin
        # depth + 1 uploaded device batches for the process's lifetime
        while not closed.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def feed():
        it = iter(iterable)
        try:
            for item in it:
                if item is None and not keep_none:
                    continue
                if not put(None if item is None else fn(item)):
                    return
        except BaseException as e:  # surface loader errors in the consumer
            errs.append(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
            put(end)

    threading.Thread(target=feed, name="device_prefetch", daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                if errs:
                    raise errs[0]
                return
            yield item.ready() if isinstance(item, Upload) else item
    finally:
        closed.set()
        # drop any queued device batches so their memory frees promptly
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break


class ShardedLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 2,
        host_id: int = 0,
        num_hosts: int = 1,
        drop_last: bool = True,
        collate: Callable = none_collate,
        prefetch: int = 4,
        use_processes: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.drop_last = drop_last
        self.collate = collate
        self.prefetch = prefetch
        self.epoch = 0
        self._skip = 0
        self._pool = None
        if use_processes:
            import multiprocessing as mp

            ctx = mp.get_context("spawn")
            self._pool = ctx.Pool(
                self.num_workers, initializer=_pool_init, initargs=(dataset,)
            )

    def close(self) -> None:
        """Stop the process pool, if any."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def set_position(self, global_batch_index: int) -> None:
        """Fast-forward so the next ``__iter__`` resumes the deterministic
        batch sequence at the given global batch index (checkpoint resume:
        the shuffle is a pure function of (seed, epoch), so epoch + intra-
        epoch offset reproduce the exact data order of an uninterrupted
        run)."""
        per = len(self)
        self.epoch = global_batch_index // per
        self._skip = global_batch_index % per

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        # host shard: strided split like DistributedSampler, cut to the same
        # length on every host (its drop_last), so that all hosts take the
        # same number of steps and meet in every collective (the JAX
        # package's loader does not cut them)
        return idx[self.host_id :: self.num_hosts][: n // self.num_hosts]

    def __iter__(self) -> Iterator[Optional[Dict[str, Any]]]:
        indices = self._epoch_indices()
        self.epoch += 1
        nb = len(indices) // self.batch_size
        if not self.drop_last and len(indices) % self.batch_size:
            nb += 1
        batches = [
            indices[i * self.batch_size : (i + 1) * self.batch_size] for i in range(nb)
        ]
        if self._skip:
            batches = batches[self._skip :]
            self._skip = 0

        if self._pool is not None:
            # process pool: imap preserves batch order; the pool pipeline
            # depth provides the prefetch overlap
            yield from self._pool.imap(_pool_fetch, batches)
            return

        job_q: "queue.Queue" = queue.Queue()
        results: Dict[int, Any] = {}
        cond = threading.Condition()
        served_box = [0]  # next batch index the consumer needs
        stop = [False]  # set when the consumer leaves early

        for i, b in enumerate(batches):
            job_q.put((i, b))

        def worker():
            while True:
                try:
                    i, b = job_q.get_nowait()
                except queue.Empty:
                    return
                # bound in-flight batches to the prefetch depth, but never
                # block the batch the consumer is waiting on (otherwise
                # faster workers can fill the window with later indices and
                # deadlock the pipeline)
                with cond:
                    while len(results) >= self.prefetch and i != served_box[0] and not stop[0]:
                        cond.wait()
                    if stop[0]:
                        return
                batch = self.collate([self.dataset[int(j)] for j in b])
                with cond:
                    results[i] = batch
                    cond.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        try:
            for served in range(len(batches)):
                with cond:
                    while served not in results:
                        cond.wait()
                    batch = results.pop(served)
                    served_box[0] = served + 1
                    cond.notify_all()
                yield batch
        finally:
            with cond:
                stop[0] = True
                cond.notify_all()

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)
