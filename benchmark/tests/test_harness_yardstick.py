"""The benchmark's arithmetic against hand counts: the reference model's
operations (its only parts that grow with the rays are the background
model's 1x1-conv MLP and the rays' rotation into the camera), the
grid-sample bytes, and the idle gaps, kernel times and module attribution
of a hand-written trace."""

import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import readers, trace, yardstick

DIMS = dict(uv_res=64, nprims=256, primsize=16, nverts=7306, ncams=10, nident=2,
            volradius=256.0, dt=16.0 / 256, tile=8, max_hit=16, nbuf=64, cull_group_size=256,
            cull_max_groups=8)
# the background MLP's multiply-adds per pixel: 120 -> 256, four 256 -> 256, 256 -> 3
BG_MACS = 120 * 256 + 4 * 256 * 256 + 256 * 3
RAY_MACS = 3 * 3  # each ray's direction through the camera rotation, no gradient


def test_forward_operations_grow_by_the_background_per_pixel():
    n = 2
    a = yardstick.counts(DIMS, n, 16, 16, backward=False)["flops"]
    b = yardstick.counts(DIMS, n, 32, 24, backward=False)["flops"]
    assert b - a == 2 * n * (32 * 24 - 16 * 16) * (BG_MACS + RAY_MACS)


def test_backward_operations_grow_by_three_times_the_background():
    n = 2
    a = yardstick.counts(DIMS, n, 16, 16, backward=True)["flops"]
    b = yardstick.counts(DIMS, n, 32, 24, backward=True)["flops"]
    pixels = n * (32 * 24 - 16 * 16)
    # forward, weight gradient and input gradient of every layer (the first
    # layer's input holds the embeddings, which take a gradient)
    assert b - a == 2 * pixels * (3 * BG_MACS + RAY_MACS)


def test_operations_scale_with_the_batch():
    one = yardstick.counts(DIMS, 1, 16, 16, backward=False)["flops"]
    three = yardstick.counts(DIMS, 3, 16, 16, backward=False)["flops"]
    assert three == 3 * one


def test_grid_sample_bytes_of_one_call():
    img = torch.randn(2, 3, 8, 8, requires_grad=True)
    grid = torch.rand(2, 5, 4, 2, requires_grad=True) * 2 - 1
    gs = yardstick._GridSampleBytes()
    with gs:
        F.grid_sample(img, grid, align_corners=False).sum().backward()
    fwd = (img.numel() + grid.numel() + 2 * 3 * 5 * 4) * 4
    bwd = (2 * 3 * 5 * 4 + img.numel() + grid.numel() + img.numel() + grid.numel()) * 4
    assert gs.bytes == fwd + bwd


def _ev(name, cat, ts, dur, **args):
    return dict(name=name, cat=cat, ph="X", ts=ts, dur=dur, pid=1, tid=1, args=args)


EVENTS = [
    _ev(trace.UNIT, "user_annotation", 0, 100),
    _ev("module:bgmodel", "user_annotation", 1, 30),
    _ev("aten::conv2d", "cpu_op", 2, 20, **{"Sequence number": 5}),
    _ev("cudaLaunchKernel", "cuda_runtime", 3, 2, correlation=1),
    _ev("module:raymarcher", "user_annotation", 40, 20),
    _ev("cudaLaunchKernel", "cuda_runtime", 41, 2, correlation=2),
    _ev(trace.UNIT, "user_annotation", 100, 100),
    _ev("autograd::engine::evaluate_function: ConvolutionBackward0", "cpu_op", 110, 30,
        **{"Sequence number": 5, "Fwd thread id": 1}),
    _ev("cudaLaunchKernel", "cuda_runtime", 112, 2, correlation=3),
    _ev("cudnn_conv_kernel", "kernel", 10, 20, correlation=1),
    _ev("mvp_march_fwd_kernel", "kernel", 50, 30, correlation=2),
    _ev("wgrad_kernel", "kernel", 120, 40, correlation=3),
]


def test_busy_union_and_gaps():
    busy, span, gaps = trace.busy_and_gaps(EVENTS)
    assert (busy, span) == (90, 200)
    assert gaps == [(0, 10), (30, 50), (80, 120), (160, 200)]
    bd = trace.breakdown(EVENTS)
    assert bd["device_ops"][0] == ["wgrad_kernel", 40e-6]
    assert [g[1] for g in bd["idle_gaps"]] == [40e-6, 40e-6, 20e-6, 10e-6]


def test_module_attribution_follows_the_backward_to_its_forward():
    by = trace.seconds_by_module(EVENTS)
    assert by == pytest.approx({"bgmodel": 60e-6, "raymarcher": 30e-6})


def test_readers():
    # the untraced window: 60 us a step, against the traced tail's 100 us
    rec = {"loop": "train", "gpu": True, "events": EVENTS, "steps": 4, "window_s": 240e-6,
           "flops_per_unit": 67e12 * 60e-6, "peak_flops": 67e12, "gs_kernels": ("wgrad",),
           "grid_sample_bytes_per_unit": 3.35e12 * 10e-6, "optimizer_s": [0.01, 0.03]}
    assert readers.idle_share(rec, "train") == pytest.approx(100 * (1 - 45 / 60))
    assert readers.mfu(rec, "train") == pytest.approx(100.0)
    assert readers.module_ms(rec, "train", ("bgmodel",)) == pytest.approx(0.03)
    assert readers.kernel_ms(rec, "train", readers.MARCH_KERNELS) == pytest.approx(0.015)
    assert readers.grid_sample_roofline(rec, "train") == pytest.approx(50.0)
    assert readers.mean_ms(rec, "optimizer_s", "train") == pytest.approx(20.0)
    assert readers.idle_share(rec, "render") is None
    assert readers.mfu(dict(rec, gpu=False), "train") is None


class _Double(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        return g * 2


class _Marcher:
    volume_radius = 1.0

    def __call__(self, x):
        rgba = _Double.apply(x)
        return rgba[..., :3], rgba[..., 3:], rgba


class _Model(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 4)
        self.raymarcher = _Marcher()

    def forward(self, x):
        return self.raymarcher(self.lin(x))[2].sum() * self.raymarcher.volume_radius


def test_the_march_backward_is_charged_to_the_raymarcher(tmp_path):
    model = _Model()
    events = trace.profile(lambda: model(torch.randn(3, 4)).backward(), 1, model,
                           tmp_path / "trace.json")
    assert isinstance(model.raymarcher, _Marcher)
    ctx = trace._contexts(events)
    resolve = trace._resolver(events, ctx)
    node = [e for e in events if e["name"].endswith("evaluate_function: _DoubleBackward")][0]
    inside = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::mul"
              and node["ts"] <= e["ts"] < node["ts"] + node["dur"]]
    assert inside and {resolve(ctx[id(e)]) for e in inside} == {"raymarcher"}
    addmm = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::addmm"]
    assert {resolve(ctx[id(e)]) for e in addmm} == {"lin"}
