# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""CUDA graphs for a model module's forward under inference.

At batch 1 the decode's modules (``IdentityEncoder``, ``ExpressionEncoder``,
``DecoderAssembler``) are a few hundred small kernels each, and launching
them one by one costs the host more time than the device takes to run them.
``GraphCache`` replays such a forward from a CUDA graph instead. The
kernels are the same; only their launch changes. A module owns one cache
(``self.graphs``) and calls it from inside its ``forward``:

    def forward(self, x, flag=False):
        return self.graphs(self, self._forward, x, flag=flag, pure=not flag)

so ``Module.__call__``, its hooks and the profiler scopes they open still
run around the replay.

**When a call is replayed.** Only when the call is a pure function of its
tensors and the module's state (``pure``: the caller rules out what must
stay eager, such as an in-place update of a buffer or a collective),
``torch.is_inference_mode_enabled()``, and every tensor argument lies on one
device of the cache's type (CUDA). Every other call runs the eager forward
unchanged: training, ``torch.no_grad`` without inference mode, CPU tensors.

**Signature.** The arguments' structure (``torch.utils._pytree``), each
tensor argument's shape, stride, dtype and device, every other argument by
value, and the ``data_ptr`` of the module's parameters and buffers. A call
with an argument that cannot be hashed runs eagerly. Weights copied into
(``load_state_dict``) keep the signature and are read by the next replay; a
parameter or buffer replaced by another tensor gives a new signature, never
a stale graph. A graph keeps the TF32 and autocast settings of its capture
(``factory.get_autoencoder`` turns TF32 off for the process). A signature is
captured the second time it is seen: the first call runs eagerly, so a call
made once pays no capture. The cache keeps at most ``MAX_SIGNATURES``
signatures, least recently used out first. A capture that fails (an
argument whose elements overlap, an operation that cannot be captured) is
logged and counted, and that signature runs eagerly from then on: the
forward never fails for the graph's sake.

**Capture** (``capture_cuda``): a warm-up of the forward on a side stream,
which does the lazy set-up of cuBLAS and cuDNN outside the capture, then
``torch.cuda.graph`` on that stream, in thread-local capture mode so that
other threads' CUDA calls neither fail nor break it.

**Aliasing.** A graph reads its inputs from static buffers and writes its
outputs into its own memory, both overwritten by the next replay. So each
call copies its tensor arguments into the buffers (made with the
arguments' strides), replays, and returns clones of the outputs (dense
outputs keep their strides): what a call returns stays valid after the next
call, as an eager forward's does.

**Counts.** ``GraphCache.counts``: captures, replays, eager calls and failed
captures; ``report(model)`` gathers them by module for a log line. A kernel
wrapper that counts its launches registers the counts
(``count_launches``): a capture records kernels without launching them, so
it takes back what the counts gained inside it, and each replay adds that
gain, so the counts stay the launches made (the capture's warm-up, which
does launch, included). The profiler shows each replay as one
``cudaGraphLaunch``, its kernels correlated to it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn
from torch.utils import _pytree as pytree

logger = logging.getLogger(__name__)

MAX_SIGNATURES = 4
_SEEN = "seen"  # a signature seen once, not captured yet
_FAILED = "failed"  # a signature whose capture failed: eager from then on

# kernel wrappers' launch counts: wrapper -> the names of its count attributes
_COUNTERS: "weakref.WeakKeyDictionary[Any, Tuple[str, ...]]" = weakref.WeakKeyDictionary()

Gains = List[Tuple[Any, str, int]]  # (wrapper, count attribute, gain)


def count_launches(wrapper: Any, *names: str) -> None:
    """Register the integer attributes ``names`` of a kernel wrapper as its
    launch counts (the module docstring's Counts)."""
    _COUNTERS[wrapper] = names


@contextlib.contextmanager
def recorded() -> Iterator[Gains]:
    """Around a capture, whose kernels are recorded, not launched: puts the
    registered launch counts back to what they were at entry, and fills the
    list it yields with what they gained inside."""
    before = [(w, name, getattr(w, name)) for w, names in list(_COUNTERS.items())
              for name in names]
    gains: Gains = []
    try:
        yield gains
    finally:
        for w, name, n in before:
            gain = getattr(w, name) - n
            if gain:
                setattr(w, name, n)
                gains.append((w, name, gain))


def capture_cuda(run: Callable[[], Any], device: torch.device
                 ) -> Tuple[Callable[[], None], Any, Gains]:
    """Capture ``run()`` (the forward on the static inputs) as a CUDA graph
    on ``device``: (the graph's replay, its static outputs, the launch
    counts' gains of one replay)."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            run()
        graph = torch.cuda.CUDAGraph()
        with recorded() as gains, torch.cuda.graph(graph, stream=side,
                                                   capture_error_mode="thread_local"):
            out = run()
        torch.cuda.current_stream(device).wait_stream(side)
    return graph.replay, out, gains


@dataclasses.dataclass
class Counts:
    captures: int = 0
    replays: int = 0
    eager: int = 0
    failed: int = 0


@dataclasses.dataclass
class _Graph:
    inputs: List[torch.Tensor]  # the static buffers, in argument order
    outputs: Any  # the static outputs
    replay: Callable[[], None]
    gains: Gains  # what one replay adds to the kernel wrappers' launch counts
    state: List[torch.Tensor]  # the parameters and buffers it read, kept alive


def _meta(x: Any) -> Any:
    return (x.shape, x.stride(), x.dtype, x.device) if isinstance(x, torch.Tensor) else x


class GraphCache:
    """One module's graphs by signature (the module docstring). ``capture``
    and ``device_type`` are what a test replaces to run the logic on the CPU."""

    def __init__(self, capture=capture_cuda, device_type: str = "cuda"):
        self.capture, self.device_type = capture, device_type
        self.entries: "collections.OrderedDict[tuple, Any]" = collections.OrderedDict()
        self.counts = Counts()

    def __call__(self, module: nn.Module, fn: Callable, *args, pure: bool = True, **kwargs):
        """``fn(*args, **kwargs)``, the eager forward of ``module``, or its replay."""
        entry = key = None
        if pure and torch.is_inference_mode_enabled():
            leaves, spec = pytree.tree_flatten((args, kwargs))
            tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
            if tensors and all(t.device == tensors[0].device
                               and t.device.type == self.device_type for t in tensors):
                state = [*module.parameters(), *module.buffers()]
                key = (spec, tuple(map(_meta, leaves)), tuple(t.data_ptr() for t in state))
                try:
                    entry = self.entries.get(key)
                except TypeError:  # an argument that cannot be hashed: eager
                    key = None
        if key is not None and entry is None:  # first sighting
            self._put(key, _SEEN)
        elif entry is _SEEN:
            entry = self._capture(key, fn, leaves, spec, tensors, state)
        if not isinstance(entry, _Graph):
            self.counts.eager += 1
            return fn(*args, **kwargs)
        self.entries.move_to_end(key)
        for buf, x in zip(entry.inputs, tensors):
            buf.copy_(x)
        entry.replay()
        for wrapper, name, gain in entry.gains:
            setattr(wrapper, name, getattr(wrapper, name) + gain)
        self.counts.replays += 1
        return pytree.tree_map_only(torch.Tensor, torch.Tensor.clone, entry.outputs)

    def _put(self, key: tuple, value: Any) -> None:
        self.entries[key] = value
        self.entries.move_to_end(key)
        while len(self.entries) > MAX_SIGNATURES:
            self.entries.popitem(last=False)

    def _capture(self, key, fn, leaves, spec, tensors, state) -> Optional[_Graph]:
        try:
            # the arguments' own strides, so the kernels see the eager call's
            # layouts (an argument whose elements overlap fails in copy_)
            inputs = [torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)
                      for x in tensors]
            for buf, x in zip(inputs, tensors):
                buf.copy_(x)
            static = iter(inputs)
            s_args, s_kwargs = pytree.tree_unflatten(
                [next(static) if isinstance(x, torch.Tensor) else x for x in leaves], spec)
            replay, outputs, gains = self.capture(lambda: fn(*s_args, **s_kwargs),
                                                  tensors[0].device)
        except Exception:  # the forward must not fail for the graph's sake
            logger.warning("CUDA graph capture failed; this signature runs eagerly",
                           exc_info=True)
            self.counts.failed += 1
            self._put(key, _FAILED)
            return None
        self.counts.captures += 1
        entry = _Graph(inputs, outputs, replay, gains, state)
        self._put(key, entry)
        return entry


def report(model: nn.Module) -> Dict[str, Dict[str, int]]:
    """Each graphed submodule's counts by qualified name."""
    return {name or type(model).__name__: dataclasses.asdict(mod.graphs.counts)
            for name, mod in model.named_modules()
            if isinstance(getattr(mod, "graphs", None), GraphCache)}
