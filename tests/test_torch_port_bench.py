# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The port's benchmark entry points on the CPU: ``ava256_tpu_torch.kbench``
against ``scripts/kbench.py`` (the same seeded scene) and run at a tiny
size, ``ava256_tpu_torch.bench`` at a tiny size (its JSON line has
``bench.py``'s keys and finite values; its knobs are ``bench.py``'s). The
times a CPU run prints are host times of the plain versions, not the card's.
"""

import contextlib
import importlib.util
import io
import json
import math

import numpy as np
import pytest
import torch

from ava256_tpu_torch import bench, kbench
from ava256_tpu_torch.ops.math3d import rodrigues

from tests import _torch_port_threads  # noqa: F401

# bench.py's JSON line (its keys, as it prints them)
TOP_KEYS = {"metric", "value", "unit", "vs_baseline", "timing", "raymarch"}
TIMING_KEYS = {"steps", "blocked_s", "pipelined_s", "chained_s", "blocked_median_s",
               "pipelined_median_s", "chained_mean_s", "noop_roundtrip_s", "noop_chained_s",
               "device"}
RAYMARCH_KEYS = {"fwd_s", "bwd_s", "bwd_over_fwd", "mrays_per_s_fwd", "x_hbm_speed_of_light",
                 "cull_s", "candidates", "alpha_mean", "scene"}


def _numbers(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _numbers(x[k])]
    if isinstance(x, list):
        return [v for item in x for v in _numbers(item)]
    return [x] if isinstance(x, (int, float)) and not isinstance(x, bool) else []


def _jax_kbench():
    spec = importlib.util.spec_from_file_location("jax_kbench", "scripts/kbench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flagship_scene_matches_jax():
    """Every array of the seeded scene equal to the JAX script's; primrot is
    each framework's Rodrigues of the same rotation vectors (their sin and
    cos round apart by an ulp), held at 1e-6."""
    ref = _jax_kbench().make_flagship_scene(batch=2, h=24, w=17, nprims=64, boxsize=4, seed=3)
    got = kbench.make_flagship_scene(batch=2, h=24, w=17, nprims=64, boxsize=4, seed=3)
    assert got["stepsize"] == ref["stepsize"]
    for k in ("raypos", "raydir", "tminmax", "primpos", "primscale", "template"):
        assert got[k].dtype == ref[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(got["primrot"],
                                  rodrigues(torch.from_numpy(got["primrvec"])).numpy())
    np.testing.assert_allclose(got["primrot"], ref["primrot"], rtol=0, atol=1e-6)


def test_kbench_refuses_tpu_kernel_flags(capsys):
    with pytest.raises(SystemExit):
        kbench.main(["--device", "cpu", "--rows", "8"])
    assert "--rows shapes the TPU kernels" in capsys.readouterr().err


def test_hbm_rate_is_the_cards_or_given(monkeypatch):
    monkeypatch.delenv("AVA256_HBM_GBPS", raising=False)
    assert kbench.hbm_rate(torch.device("cuda")) == 3350.0
    assert kbench.hbm_rate(torch.device("cpu")) is None
    monkeypatch.setenv("AVA256_HBM_GBPS", "2000")
    assert kbench.hbm_rate(torch.device("cuda")) == 2000.0


@pytest.mark.parametrize("backend", ["cuda", "xla"])
def test_kbench_runs_on_cpu(backend, monkeypatch):
    monkeypatch.setenv("AVA256_HBM_GBPS", "100")  # a rate for this run's device
    out = io.StringIO()
    # small boxes, few rays: the plain versions' time grows with the samples
    argv = ["--device", "cpu", "--backend", backend, "--batch", "1", "--hw", "16x16",
            "--nprims", "4096", "--boxsize", "2", "--steps", "1", "--tile", "8",
            "--max-hit", "32", "--max-samples", "512", "--chunk-tiles", "4"]
    with contextlib.redirect_stdout(out):
        assert kbench.main(argv) == 0
    rep, = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert rep["backend"] == backend and rep["device"] == "cpu" and rep["hbm_gbps"] == 100.0
    assert RAYMARCH_KEYS - {"scene"} <= set(rep)
    assert all(math.isfinite(v) for v in _numbers(rep))
    assert rep["candidates"] > 0 and 0.0 < rep["alpha_mean"] < 1.0
    if backend == "xla":
        assert rep["overflow_rays"] == 0 and rep["max_samples"] == 512


def test_bench_knobs_are_bench_py_s():
    assert bench.knobs({}) == dict(steps=5, batch=4, nprims=16384, primsize=8, height=512,
                                   width=334, raymarch=True, save_march=None)
    env = {"AVA256_BENCH_STEPS": "3", "AVA256_BENCH_BATCH": "2", "AVA256_BENCH_NPRIMS": "262144",
           "AVA256_BENCH_PRIMSIZE": "2", "AVA256_BENCH_HW": "256x167",
           "AVA256_BENCH_RAYMARCH": "0", "AVA256_BENCH_SAVE_MARCH": "m.npz"}
    assert bench.knobs(env) == dict(steps=3, batch=2, nprims=262144, primsize=2, height=256,
                                    width=167, raymarch=False, save_march="m.npz")


def test_bench_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])


def test_bench_prints_bench_py_s_line_on_cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("AVA256_HBM_GBPS", "100")
    monkeypatch.delenv("AVA256_TOPOLOGY", raising=False)
    save = tmp_path / "march.npz"
    res = bench.bench("cpu", steps=1, batch=2, nprims=256, primsize=16, height=16, width=16,
                      texsize=64, save_march=str(save),
                      raymarch_options={"tile": 8, "max_hit": 16, "nbuf": 64, "dt": 16.0})
    line = json.dumps(res)
    assert "\n" not in line
    res = json.loads(line)
    assert set(res) == TOP_KEYS
    assert res["metric"] == "train_steps_per_sec_per_chip_b2_16x16_K256"
    assert res["unit"] == "steps/s/chip"
    assert TIMING_KEYS <= set(res["timing"]) and RAYMARCH_KEYS <= set(res["raymarch"])
    assert res["timing"]["device"] == "cpu" and res["timing"]["march_launches"] == [0, 0]
    assert all(math.isfinite(v) for v in _numbers(res))
    # bench.py's scaling to batch 4 at 512x334 (tiny here: value rounds to ~0)
    dt = res["timing"]["pipelined_median_s"]
    assert len(res["timing"]["pipelined_s"]) == 1 and dt > 0
    assert abs(res["value"] - (1.0 / dt) * (2 / 4.0) * (16 * 16) / (512 * 334)) <= 1e-4
    scene = kbench.load_scene_npz(save)
    assert scene["stepsize"] == 16.0 / 256.0
    assert scene["template"].shape == (2, 256, 16, 16, 16, 4)
