# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""``model.dtype: bfloat16`` in the port against the JAX package's bfloat16
model (``get_autoencoder(dtype=jnp.bfloat16)``) on the CPU, on the reduced
model of ``tests/test_torch_port_model.py`` (64^2 textures, 256 primitives of
16^3, 32x32 rays), float32 parameters shared through ``convert.load_flax``.

- (a) each layer (``LinearWN``, ``Conv2dWN``, ``ConvTranspose2dWN``,
  ``Linear``, ``Conv2d``) with ``dtype=bfloat16`` on the same inputs and
  parameters: bfloat16 out; every element within one bfloat16 ulp,
  |d| <= 2^-7 |ref|, plus an ulp of the layer's largest output, 2^-8 max
  |ref|; at least 99 % of the elements bitwise equal (the share is
  printed), and at least 99.9 % equal to the exactly rounded result (the
  product in float64 of the bfloat16 input and weight, rounded, plus the
  bfloat16 bias, rounded; JAX's share of it is printed). With the same
  rounding points only the float32 sum order would be left, but JAX's CPU
  convolutions are not always correctly rounded: a few of their outputs miss
  the exactly rounded value, some by more than an ulp where terms cancel,
  hence the absolute term and the shares under 100 %;
- (b) the dtype of every module output and of every key of the output dict,
  from ``jax.eval_shape`` of the JAX model with ``capture_intermediates``
  against forward hooks on the port's modules: equal;
- (c) the whole slice, as ``test_slice_matches_jax``: a sampled warm-up
  forward (JAX's own draw of the bottleneck noise fed to the port and to the
  float32 JAX model) and a deterministic one: irgbrec within 3e-3, verts and
  adaptwarps within 2e-3 of their max |ref|; the port closer to JAX's
  bfloat16 result than JAX's float32 result is: the vertices' max |d| at most
  half of JAX's, the image's mean |d| at most half of JAX's. The image's max
  |d| is printed, not held to half (it reads 0.79-0.81 of JAX's): each layer
  the two differ on (JAX's misses, see (c')) changes an ulp that the next
  layers carry on, and a single pixel's largest difference follows the worst
  of those chains;
- (c') each layer of the model fed JAX's bfloat16 values: the port's
  forward with every layer's output replaced by JAX's, so that the
  operations between the layers work on JAX's values. Every layer's input
  equal to JAX's (>= 99 %), every layer's output exactly rounded (>= 99.9 %;
  JAX's own share falls to 98.7 % in the identity encoder), every other
  module's output equal to JAX's (bfloat16 bitwise, float32 within 2e-5),
  and the image made from JAX's layer outputs within 1e-5 of JAX's: the
  port rounds where JAX rounds, and what (c) measures is JAX's conv misses
  carried through the towers;
- (d) one bfloat16 training step (residuals on, the warm-up's scales)
  against JAX's ``make_train_step`` on the bfloat16 model: each loss term and
  the total within 1e-3 relative; every parameter's gradient at cosine >=
  0.985 to JAX's (above JAX's own bfloat16-to-float32 cosine, 0.9835); the
  port's bfloat16 gradient closer to JAX's than the port's float32 gradient
  is for most parameters (what a port that missed bfloat16 would give);
  parameters float32 after the update. Against the port's float32 step the
  port's lowest cosine is no lower than JAX's, and the port's gradient is the
  closer one for most parameters;
- (e) ``build_model`` maps ``model.dtype`` (bfloat16 builds the bfloat16
  model, float16 is refused), and ``load_flax`` carries the JAX bfloat16
  model's parameters, a float32 tree, into the port's bfloat16 model;
  ``cli.generate_id_cond`` on a bfloat16 checkpoint writes the codes as
  float32 (numpy has no bfloat16), each value a bfloat16 one.

The JAX references in (c), (c') and (d) are compiled with XLA's excess
precision off (``STRICT``): with it on, JAX's CPU compiler skips a bfloat16
rounding where a layer's output meets a float32 operation in one fusion.
"""

import pickle
from unittest import mock

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch

from ava256_tpu_torch.config import load_config
from ava256_tpu_torch.convert import flax_to_state_dict, load_flax
from ava256_tpu_torch.data.synthetic import SyntheticDataset, none_collate, synthetic_uvdata
from ava256_tpu_torch.factory import get_autoencoder
from ava256_tpu_torch.ops import layers
from ava256_tpu_torch.train import loop
from ava256_tpu_torch.train.state import TrainState, make_optimizer
from ava256_tpu_torch.train.step import make_train_step

from tests import _torch_port_threads  # noqa: F401
from ava256_tpu.factory import get_autoencoder as jax_get_autoencoder
from ava256_tpu.ops import layers as jax_layers
from ava256_tpu.train.step import BATCH_MODEL_KEYS, make_train_step as jax_make_train_step
from ava256_tpu.train import state as jax_state

from tests.test_torch_port_model import OPTS, SIZES, _jax_forward, _perturb, _port_forward
from tests.test_torch_port_train import LOSS_WEIGHTS, NORMAL, _capture_grads

BF16 = torch.bfloat16


def _np(x) -> np.ndarray:
    """A JAX or torch array as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x).astype(jnp.float32), dtype=np.float64)


def _maxd(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


# XLA's CPU compiler may keep a bfloat16 value in float32 where a float32
# operation follows it in the same fusion ("excess precision", on by
# default), and so skips the rounding that flax's ``dtype`` places at a
# layer's output (the rgb decoder's last layer before its float32 slab bias,
# say). The JAX references are compiled with it off: bfloat16 as the model
# states it, which is what the port computes.
STRICT = {"xla_allow_excess_precision": False}


def _strict(f, *args, static=None, **kwargs):
    """``f(*args, **static, **kwargs)`` jitted (unless it is) and compiled
    with STRICT; ``static`` holds f's static arguments."""
    jitted = f if hasattr(f, "lower") else jax.jit(f)
    return jitted.lower(*args, **(static or {}), **kwargs).compile(STRICT)(*args, **kwargs)


# ---------------------------------------------------------------------------
# (a) the layers
# ---------------------------------------------------------------------------

# (name, JAX module, port module, input shape NHWC or [..., in])
LAYER_CASES = {
    "LinearWN 16->128": (lambda: jax_layers.LinearWN(128, dtype=jnp.bfloat16),
                         lambda: layers.LinearWN(16, 128, dtype=BF16), (256, 16)),
    "Conv2dWN 1x1 64->16": (lambda: jax_layers.Conv2dWN(16, 1, dtype=jnp.bfloat16),
                            lambda: layers.Conv2dWN(64, 16, 1, dtype=BF16), (2, 16, 16, 64)),
    "Conv2dWN 3x3 32->64": (
        lambda: jax_layers.Conv2dWN(64, 3, 1, 1, dtype=jnp.bfloat16),
        lambda: layers.Conv2dWN(32, 64, 3, 1, 1, dtype=BF16), (2, 16, 16, 32)),
    "Conv2dWN 4x4/2 16->32": (
        lambda: jax_layers.Conv2dWN(32, 4, 2, 1, dtype=jnp.bfloat16),
        lambda: layers.Conv2dWN(16, 32, 4, 2, 1, dtype=BF16), (2, 32, 32, 16)),
    "ConvTranspose2dWN 4x4/2 64->32": (
        lambda: jax_layers.ConvTranspose2dWN(32, dtype=jnp.bfloat16),
        lambda: layers.ConvTranspose2dWN(64, 32, dtype=BF16), (2, 16, 16, 64)),
    "ConvTranspose2dWN 4x4/2 16->48": (
        lambda: jax_layers.ConvTranspose2dWN(48, dtype=jnp.bfloat16),
        lambda: layers.ConvTranspose2dWN(16, 48, dtype=BF16), (2, 32, 32, 16)),
    "Linear 256->40": (lambda: jax_layers.Linear(40, dtype=jnp.bfloat16),
                       lambda: layers.Linear(256, 40, dtype=BF16), (64, 256)),
    "Conv2d 1x1 256->256": (lambda: jax_layers.Conv2d(256, 1, dtype=jnp.bfloat16),
                            lambda: layers.Conv2d(256, 256, 1, dtype=BF16), (2, 8, 8, 256)),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_rounds_as_jax(case):
    make_jax, make_port, shape = LAYER_CASES[case]
    rng = np.random.RandomState(sorted(LAYER_CASES).index(case))
    x = rng.randn(*shape).astype(np.float32)
    jm = make_jax()
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), x)["params"])
    params = _perturb(params, rng)  # a non-zero bias, g away from ||w||
    ref = jm.apply({"params": params}, x)
    port = load_flax(make_port(), {"params": params})
    nchw = len(shape) == 4
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = port(xt.permute(0, 3, 1, 2) if nchw else xt)
        got = got.permute(0, 2, 3, 1) if nchw else got
    assert ref.dtype == jnp.bfloat16 and got.dtype == BF16
    a, b = _np(got), _np(ref)
    lim = 2.0**-7 * np.abs(b) + 2.0**-8 * np.abs(b).max()
    assert (np.abs(a - b) <= lim).all(), f"{case}: max |d| - limit {(np.abs(a - b) - lim).max()}"
    share = float(np.mean(a == b))
    # the exactly rounded result: the product of the bfloat16 input and
    # weight in float64, rounded to bfloat16, plus the bfloat16 bias, rounded
    with torch.no_grad():
        w = (port.effective_weight() if hasattr(port, "g") else port.weight).to(BF16).double()
        xe = xt.to(BF16).double()
        exact = port._op(xe.permute(0, 3, 1, 2), w, None).permute(0, 2, 3, 1) if nchw \
            else torch.nn.functional.linear(xe, w)
        exact = _np(exact.to(BF16) + port.bias.to(BF16))
    port_exact, jax_exact = float(np.mean(a == exact)), float(np.mean(b == exact))
    print(f"{case}: {share:.5f} of {a.size} elements bitwise equal; exactly rounded: "
          f"port {port_exact:.5f}, JAX {jax_exact:.5f}")
    assert share >= 0.99, share
    assert port_exact >= 0.999, port_exact


def test_weak_scalars_round_as_jax():
    """A Python scalar meets a bfloat16 tensor rounded to bfloat16 in JAX;
    ``layers.weak`` gives the port the same product, and leaves float32 alone."""
    x = np.random.RandomState(0).randn(4096).astype(np.float32)
    xb = torch.from_numpy(x).to(BF16)
    for c in (0.2, 0.1, 0.01, 1e-5):
        ref = _np(jnp.asarray(x).astype(jnp.bfloat16) * c)
        np.testing.assert_array_equal(_np(xb * layers.weak(c, xb)), ref)
    assert layers.weak(0.2, torch.from_numpy(x)) == 0.2


# ---------------------------------------------------------------------------
# the reduced model in bfloat16, both sides
# ---------------------------------------------------------------------------


def _jax_model(dsj, dtype):
    from __graft_entry__ import _uvdata

    return jax_get_autoencoder(
        _uvdata(SIZES["texsize"]), vertmean=dsj.vertmean, vertstd=dsj.vertstd,
        ncams=SIZES["ncams"], nident=SIZES["nident"], nprims=SIZES["nprims"],
        primsize=(SIZES["primsize"],) * 3, raymarch_backend="pallas",
        raymarch_options=dict(OPTS, interpret=True), dtype=dtype)


def _port_model(ds, tree, dtype=BF16):
    port = get_autoencoder(synthetic_uvdata(SIZES["texsize"]), ds.vertmean, ds.vertstd,
                           ncams=SIZES["ncams"], nident=SIZES["nident"], nprims=SIZES["nprims"],
                           primsize=(SIZES["primsize"],) * 3, raymarch_options=OPTS,
                           device="cpu", dtype=dtype)
    return load_flax(port, tree)


@pytest.fixture(scope="module")
def setup():
    from __graft_entry__ import _build
    from ava256_tpu.train.init import init_model

    jm32, mb, dsj = _build(raymarch_backend="pallas",
                           raymarch_options=dict(OPTS, interpret=True), **SIZES)
    jm16 = _jax_model(dsj, jnp.bfloat16)
    variables = init_model(jm32, jax.random.PRNGKey(0), mb)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    tree = {"params": _perturb(tree["params"], np.random.RandomState(7)),
            "stats": tree["stats"]}
    ds = SyntheticDataset(nident=SIZES["nident"], ncams=SIZES["ncams"], height=32, width=32,
                          texsize=64)
    batch_np = none_collate([ds[i] for i in range(SIZES["batch"])])
    tb = {k: torch.from_numpy(np.asarray(batch_np[k])) for k in mb}
    return jm32, jm16, mb, dsj, ds, tree, tb


def _recording_normal(drawn):
    """jax.random.normal that also keeps what it drew (the bottleneck's noise)."""
    normal = jax.random.normal

    def record(*args, **kwargs):
        drawn.append(normal(*args, **kwargs))
        return drawn[-1]

    return mock.patch.object(jax.random, "normal", record)


# ---------------------------------------------------------------------------
# (b) the dtype map
# ---------------------------------------------------------------------------


def _leaves(x) -> list:
    """A module output's tensors in JAX's flattening order (dict keys sorted)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _leaves(y)]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    return []


def _dtypes(x) -> list:
    """The dtypes of a module output's tensors in JAX's flattening order."""
    return [str(t.dtype).replace("torch.", "") for t in _leaves(x)]


def test_dtype_map_matches_jax(setup):
    jm32, jm16, mb, _, ds, tree, tb = setup
    jvars = jax.tree_util.tree_map(jnp.asarray, tree)
    out, inter = jax.eval_shape(lambda v, b: _jax_forward(
        jm16, v, b, deterministic=True, capture_intermediates=True,
        mutable=["intermediates"]), jvars, mb)
    ref = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(inter["intermediates"])[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        name = ".".join(keys[:keys.index("__call__")])
        ref.setdefault(name, []).append(str(leaf.dtype))

    port = _port_model(ds, tree)
    got = {}
    hooks = [m.register_forward_hook(
        lambda m, i, o, name=name: got.__setitem__(name, _dtypes(o)))
        for name, m in port.named_modules()]
    tout = _port_forward(port, tb, deterministic=True)
    for h in hooks:
        h.remove()
    assert set(ref) <= set(got), sorted(set(ref) - set(got))
    bad = {name: (got[name], want) for name, want in ref.items() if got[name] != want}
    assert not bad, bad
    print(f"{len(ref)} module outputs compared")
    # the rows of the JAX table the port must reproduce
    assert ref["identity_encoder"] == ["float32"] * 8 + ["bfloat16"] * 2  # b_geo, b_tex, z_*
    assert ref["decoder_assembler.geodec"] == ["float32"] * 2 + ["bfloat16"] * 3
    assert ref["decoder_assembler.rgbdec"] == ["float32"]
    assert set(ref["decoder_assembler"]) == {"float32"} and ref["colorcal"] == ["float32"]
    assert ref["bgmodel"] == ["bfloat16"] and set(ref["bottleneck"]) == {"bfloat16"}
    keys = {k: str(v.dtype) for k, v in out.items() if v is not None}
    assert keys == {k: str(v.dtype).replace("torch.", "") for k, v in tout.items()
                    if v is not None}
    assert keys == {"encoding": "bfloat16", "expr_mu": "bfloat16", "expr_logstd": "bfloat16",
                    "irgbrec": "float32", "verts": "float32"}


# ---------------------------------------------------------------------------
# (c) the whole slice
# ---------------------------------------------------------------------------


def _exactly_rounded(module, x) -> torch.Tensor:
    """What a bfloat16 layer gives for ``x`` when every rounding is exact:
    the product of the bfloat16 input and weight in float64, rounded to
    bfloat16, plus the bfloat16 bias, rounded."""
    w = module.effective_weight() if hasattr(module, "g") else module.weight
    op = getattr(module, "_op", lambda x, w, b: torch.nn.functional.linear(x, w))
    y = op(x.to(BF16).double(), w.to(BF16).double(), None).to(BF16)
    if module.bias is None:
        return y
    return y + module.bias.to(BF16).reshape((-1, 1, 1) if y.ndim == 4 else (-1,))


JAX_LAYERS = (jax_layers.LinearWN, jax_layers.Conv2dWN, jax_layers.ConvTranspose2dWN,
              jax_layers.Linear, jax_layers.Conv2d)
LAYERS = (layers.LinearWN, layers.Conv2dWN, layers.ConvTranspose2dWN, layers.Linear,
          layers.Conv2d)


def _jax_names(inter) -> dict:
    """capture_intermediates' outputs by module path, each a list of leaves."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(inter["intermediates"])[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        out.setdefault(".".join(keys[:keys.index("__call__")]), []).append(leaf)
    return out


@pytest.fixture(scope="module")
def slice_runs(setup):
    """JAX's forwards of the slice, bfloat16 and float32: the sampled warm-up
    (the bfloat16 model's draw fed to the float32 one) and a deterministic
    render with the warm-up's statistics, the bfloat16 one with every
    module's output and every layer's input captured. All compiled STRICT."""
    jm32, jm16, mb, dsj, ds, tree, tb = setup
    jvars = jax.tree_util.tree_map(jnp.asarray, tree)

    def jax_warm(model, noise=None):
        drawn = []
        patch = (_recording_normal(drawn) if noise is None else mock.patch.object(
            jax.random, "normal", lambda key, shape, dtype: jnp.asarray(noise, dtype)))
        with patch:
            out, mut, draw = _strict(lambda v, b, k: (*_jax_forward(
                model, v, b, running_avg_scale=True, mutable=["stats"],
                rngs={"sample": k}), drawn[-1] if noise is None else None),
                jvars, mb, jax.random.PRNGKey(3))
        return out, mut["stats"], draw

    j16, stats, noise = jax_warm(jm16)
    assert noise.dtype == jnp.bfloat16
    noise = np.array(noise.astype(jnp.float32))
    j32, stats32, _ = jax_warm(jm32, noise)
    jvars2 = {"params": jvars["params"], "stats": stats}
    # the deterministic render, every layer's input recorded as well: on a
    # model built and run without nn.remat (a forward computes the same
    # values; a value recorded inside a remat would leave its trace)
    inputs = {}

    def record(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and isinstance(context.module, JAX_LAYERS):
            inputs[".".join(context.module.scope.path)] = args[0]
        return next_fun(*args, **kwargs)

    def render(v, b):
        out = _jax_forward(jm16_plain, v, b, deterministic=True, capture_intermediates=True,
                           mutable=["intermediates"])
        return out, dict(inputs)

    with mock.patch.object(nn, "remat", lambda target, *a, **k: target), \
            nn.intercept_methods(record):
        jm16_plain = _jax_model(dsj, jnp.bfloat16)
        (d16, inter), layer_inputs = _strict(render, jvars2, mb)
    d32 = _strict(lambda v, b: _jax_forward(jm32, v, b, deterministic=True), jvars2, mb)
    return dict(warm=(j16, j32), stats=(stats, stats32), noise=noise, det=(d16, d32),
                inter=_jax_names(inter), inputs=layer_inputs)


def test_slice_matches_jax_bf16(setup, slice_runs):
    jm32, jm16, mb, _, ds, tree, tb = setup
    port = _port_model(ds, tree)
    port.eval()
    port.decoder_assembler.adaptwarps.zero_()

    # 1) the warm-up forward: JAX's bfloat16 draw fed to the port (and to the
    # float32 JAX model)
    noise = slice_runs["noise"]
    t16 = _port_forward(port, tb, running_avg_scale=True, noise=torch.from_numpy(noise).to(BF16))
    stats, stats32 = slice_runs["stats"]
    aw = stats["decoder_assembler"]["adaptwarps"]
    assert float(np.asarray(aw).max()) > 0
    runs = [("warm-up", *slice_runs["warm"], t16,
             (port.decoder_assembler.adaptwarps, aw, stats32["decoder_assembler"]["adaptwarps"]))]

    # 2) a deterministic render with the updated statistics
    t16 = _port_forward(port, tb, deterministic=True)
    runs.append(("deterministic", *slice_runs["det"], t16, None))

    for run, j16, j32, t16, warps in runs:
        assert t16["irgbrec"].dtype == torch.float32 and t16["encoding"].dtype == BF16
        irgb = _np(j16["irgbrec"])
        assert np.isfinite(irgb).all() and irgb.std() > 1.0
        for key, rel in (("irgbrec", 3e-3), ("verts", 2e-3)):
            d, gap = _maxd(t16[key], j16[key]), _maxd(j32[key], j16[key])
            mean_d = np.abs(_np(t16[key]) - _np(j16[key])).mean()
            mean_gap = np.abs(_np(j32[key]) - _np(j16[key])).mean()
            lim = rel * np.abs(_np(j16[key])).max()
            print(f"{run} {key}: port vs JAX bf16 max |d| {d:.4g} (limit {lim:.4g}), "
                  f"JAX fp32 vs JAX bf16 {gap:.4g}, ratio {d / gap:.3g}; mean |d| "
                  f"{mean_d:.3g} vs {mean_gap:.3g}, ratio {mean_d / mean_gap:.3g}")
            assert d <= lim, (run, key, d, lim)
            if key == "verts":
                assert d <= 0.5 * gap, (run, key, d, gap)
            else:  # the image: on the mean (see the docstring)
                assert mean_d <= 0.5 * mean_gap, (run, key, mean_d, mean_gap)
        if warps is not None:
            got, ref, ref32 = warps
            d = _maxd(got, ref)
            print(f"{run} adaptwarps: max |d| {d:.4g}, JAX fp32 vs bf16 {_maxd(ref32, ref):.4g}")
            assert d <= 2e-3 * np.abs(_np(ref)).max()


def _nhwc(t: torch.Tensor, like) -> np.ndarray:
    a = _np(t)
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 and a.shape != tuple(like.shape) else a


def test_model_layers_round_as_jax(setup, slice_runs):
    """Every layer of the bfloat16 model, handed what JAX's bfloat16 model
    computed before it: the port's deterministic forward with each layer's
    output replaced by JAX's (captured in the same render), so that the
    port's operations between the layers (activations, bias pyramids, warps,
    concats, casts) work on JAX's values. Held:

    - each layer's input, as the layer casts it, bitwise equal to JAX's on
      >= 99 % of its elements (the operations before the layer round as
      JAX's do; the background model's first input, a sin/cos encoding of
      float32 coordinates that the two libraries round apart by an ulp now
      and then, is the lowest, at 99.5 %);
    - each layer's output exactly rounded (the product of the bfloat16 input
      and weight in float64, rounded, plus the bfloat16 bias, rounded) on
      >= 99.9 % of its elements; JAX's share of that is printed (down to
      98.7 %: JAX's CPU convolutions miss it now and then, which is where the
      two differ);
    - every other module's output: its bfloat16 tensors bitwise equal to
      JAX's on >= 99.9 %, its float32 ones within 2e-5 of their max |ref|
      (5.2e-6 in the bias pyramids, float32 sums in another order);
    - the image within 1e-5 of JAX's max |ref| and 1 % of JAX's own
      float32-to-bfloat16 gap."""
    jm32, jm16, mb, _, ds, tree, tb = setup
    stats = jax.tree_util.tree_map(np.asarray, slice_runs["stats"][0])
    port = _port_model(ds, {"params": tree["params"], "stats": stats})
    port.eval()
    ref, ref_in = slice_runs["inter"], slice_runs["inputs"]
    shares, outputs = {}, {}

    def forced(name):
        def hook(module, args, out):
            want = ref[name][0]
            w = torch.from_numpy(_np(want).astype(np.float32)).to(out.dtype)
            if out.ndim == 4:  # NHWC in JAX
                w = w.permute(0, 3, 1, 2).contiguous()
            assert w.shape == out.shape and str(out.dtype)[6:] == str(want.dtype), name
            x_in = ref_in[name].astype(jnp.bfloat16)
            exact = _exactly_rounded(module, args[0])
            x = _np(args[0].to(BF16))
            x = x.transpose(0, 2, 3, 1) if x.ndim == 4 else x  # NCHW in the port
            shares[name] = (float(np.mean(x == _np(x_in))),
                            float((out == exact).float().mean()),
                            float((w == exact).float().mean()))
            return w
        return hook

    hooks = [m.register_forward_hook(forced(name)) if isinstance(m, LAYERS) else
             m.register_forward_hook(lambda m, a, o, name=name: outputs.__setitem__(name, o))
             for name, m in port.named_modules() if name in ref]
    out = _port_forward(port, tb, deterministic=True)
    for h in hooks:
        h.remove()
    assert len(shares) > 60 and set(shares) == set(ref_in)
    lowest = [min(shares.items(), key=lambda kv: kv[1][i]) for i in range(3)]
    print(f"{len(shares)} layers; lowest shares: input = JAX's {lowest[0]}, output exactly "
          f"rounded {lowest[1]}, JAX's exactly rounded {lowest[2]}")
    assert lowest[0][1][0] >= 0.99 and lowest[1][1][1] >= 0.999, lowest
    worst = {"bfloat16": (1.0, ""), "float32": (0.0, "")}
    for name, o in outputs.items():
        for i, (got, want) in enumerate(zip(_leaves(o), ref[name])):
            a, b = _nhwc(got, want), _np(want)
            if got.dtype == BF16:
                v = float(np.mean(a == b))
                worst["bfloat16"] = min(worst["bfloat16"], (v, f"{name}[{i}]"))
            else:
                v = float(np.abs(a - b).max() / np.abs(b).max())
                worst["float32"] = max(worst["float32"], (v, f"{name}[{i}]"))
    print(f"{len(outputs)} other modules; lowest bfloat16 share equal, largest float32 "
          f"max |d| / max |ref|: {worst}")
    assert worst["bfloat16"][0] >= 0.999 and worst["float32"][0] <= 2e-5, worst
    d16, d32 = slice_runs["det"]
    d, gap = _maxd(out["irgbrec"], d16["irgbrec"]), _maxd(d32["irgbrec"], d16["irgbrec"])
    print(f"irgbrec from JAX's layer outputs: max |d| {d:.4g}, JAX fp32 vs bf16 {gap:.4g}")
    assert d <= 1e-5 * np.abs(_np(d16["irgbrec"])).max() and d <= 0.01 * gap, (d, gap)


# ---------------------------------------------------------------------------
# (d) one training step
# ---------------------------------------------------------------------------


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.numpy().astype(np.float64), b.numpy().astype(np.float64)
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum() + 1e-300))


def test_train_step_matches_jax_bf16(setup):
    """A normal step (residuals on, the warm-up's primitive scales)."""
    jm32, jm16, mb, dsj, ds, tree, tb = setup
    # as in tests/test_torch_port_train.py: an opacity of about 0.3 gives rays
    # of every kind (saturated, partly covered, empty)
    params = jax.tree_util.tree_map(np.copy, tree["params"])
    geodec = params["decoder_assembler"]["geodec"]
    geodec["slab_bias"] = geodec["slab_bias"] - 12.0
    forward = dict(target_neut_avgtex=mb["neut_avgtex"], target_neut_verts=mb["neut_verts"],
                   idindex=mb["idindex"], camindex=mb["camindex"], render=False,
                   **{k: mb[k] for k in BATCH_MODEL_KEYS})
    jvars = jax.tree_util.tree_map(jnp.asarray, {"params": params, "stats": tree["stats"]})
    rng = jax.random.PRNGKey(3)
    drawn = []
    with _recording_normal(drawn):  # the warm-up's statistics, and the step's draw
        stats, noise = _strict(lambda v, k: (
            jm16.apply(v, running_avg_scale=True, mutable=["stats"], rngs={"sample": k},
                       **forward)[1]["stats"], drawn[-1]), jvars, rng)
    tree = {"params": params, "stats": jax.tree_util.tree_map(np.asarray, stats)}
    jvars = jax.tree_util.tree_map(jnp.asarray, tree)
    noise = torch.from_numpy(np.array(noise.astype(jnp.float32)))
    tx = _capture_grads()
    jstep = jax_make_train_step(jm16, tx, LOSS_WEIGHTS, dsj.vertmean, dsj.vertstd)
    jnew, jtotal, jterms = _strict(
        jstep, jax_state.create_train_state(jvars, tx), mb, rng,
        static={k: NORMAL[k] for k in ("running_avg_scale", "use_gt_geo")},
        residuals_weight=NORMAL["residuals_weight"])
    ref = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jnew.opt_state),
                              "stats": tree["stats"]}, _port_model(ds, tree))

    grads = {}
    for dtype in (BF16, None):  # the port in bfloat16, and in float32 for scale
        port = _port_model(ds, tree, dtype)
        assert layers.REMAT  # the step recomputes its checkpointed blocks in bfloat16
        opt = make_optimizer(port, "adam", 2e-4, 1.4, 10_000, 1.0)
        step = make_train_step(port, opt, LOSS_WEIGHTS, ds.vertmean, ds.vertstd)
        _, total, terms = step(TrainState(port, opt, 0), tb,
                               noise=noise.to(dtype or torch.float32), **NORMAL)
        grads[dtype] = {n: p.grad for n, p in port.named_parameters()}
        if dtype is BF16:
            assert {p.dtype for p in port.parameters()} == {torch.float32}
            assert set(terms) == set(jterms)
            for k in jterms:
                assert str(terms[k].dtype)[6:] == str(jterms[k].dtype), k
                d = abs(float(terms[k]) - float(jterms[k]))
                print(f"{k}: port {float(terms[k]):.6g} JAX {float(jterms[k]):.6g} |d| {d:.3g}")
                assert d <= 1e-3 * abs(float(jterms[k])), (k, d)
            assert abs(float(total) - float(jtotal)) <= 1e-3 * abs(float(jtotal))

    vs_jax, port_to_32, jax_to_32 = {}, {}, {}
    for name, g in grads[BF16].items():
        if float(ref[name].abs().max()) == 0.0:
            assert g is None or float(g.abs().max()) == 0.0, name
            continue
        assert g is not None and bool(torch.isfinite(g).all()), name
        vs_jax[name] = _cosine(g, ref[name])
        port_to_32[name] = _cosine(g, grads[None][name])
        jax_to_32[name] = _cosine(ref[name], grads[None][name])
    closer = sum(port_to_32[n] >= jax_to_32[n] for n in vs_jax)
    # the port's float32 step, as a port that missed bfloat16 would give it,
    # lies farther from JAX's bfloat16 gradient for most parameters
    beats_fp32 = sum(vs_jax[n] > jax_to_32[n] for n in vs_jax)
    print(f"{len(vs_jax)} gradients: cosine to JAX's bf16 >= {min(vs_jax.values()):.6f}; to the "
          f"port's fp32 step >= {min(port_to_32.values()):.6f} (JAX's bf16: "
          f">= {min(jax_to_32.values()):.6f}), the port's the closer in {closer}; to JAX's bf16 "
          f"the port's bf16 step is closer than its fp32 step in {beats_fp32}")
    assert len(vs_jax) > 50
    assert min(vs_jax.values()) >= 0.985, min(vs_jax.items(), key=lambda kv: kv[1])
    assert beats_fp32 > 0.5 * len(vs_jax), beats_fp32
    # bfloat16 itself moves a gradient this far from float32: the port's no
    # farther than JAX's, and the closer of the two for most parameters
    assert min(port_to_32.values()) >= min(jax_to_32.values())
    assert closer >= 0.6 * len(vs_jax)


# ---------------------------------------------------------------------------
# (e) the loop's configuration and the weights
# ---------------------------------------------------------------------------


SHRINK = ["model.nprims=256", "model.primsize=16", "data.synthetic_texsize=64",
          "data.synthetic_height=16", "data.synthetic_width=16", "train.batchsize=1",
          "model.raymarch.tile=8", "model.raymarch.max_hit=16", "model.raymarch.nbuf=64",
          "model.raymarch.dt=16.0"]


def test_build_model_maps_model_dtype():
    dtypes = {}
    for value in ("bfloat16", "float32"):
        cfg = load_config("configs/config-synthetic.yaml", SHRINK + [f"model.dtype={value}"])
        model = loop.build_model(cfg, loop.build_dataset(cfg), synthetic_uvdata(64), "cpu")
        dtypes[value] = {m.dtype for m in model.modules() if hasattr(m, "dtype")}
        assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert dtypes == {"bfloat16": {BF16}, "float32": {None}}
    cfg = load_config("configs/config-synthetic.yaml", SHRINK + ["model.dtype=float16"])
    with pytest.raises(ValueError, match="model.dtype"):
        loop.build_model(cfg, loop.build_dataset(cfg), synthetic_uvdata(64), "cpu")


def test_load_flax_takes_a_jax_bf16_tree(setup):
    """The JAX bfloat16 model's parameter tree is the float32 model's: the
    same leaves, all float32; ``load_flax`` loads it into the port's bfloat16
    model unchanged."""
    jm32, jm16, mb, _, ds, tree, tb = setup
    from ava256_tpu.train.init import init_model

    shapes16, shapes32 = (jax.eval_shape(lambda k, m=m: init_model(m, k, mb),
                                         jax.random.PRNGKey(1)) for m in (jm16, jm32))
    assert jax.tree_util.tree_structure(shapes16) == jax.tree_util.tree_structure(tree)
    assert jax.tree_util.tree_leaves(shapes16) == jax.tree_util.tree_leaves(shapes32)
    assert {x.dtype for x in jax.tree_util.tree_leaves(shapes16)} == {jnp.dtype(jnp.float32)}
    port = _port_model(ds, tree)
    sd = port.state_dict()
    for key, want in flax_to_state_dict(tree, port).items():
        assert sd[key].dtype == torch.float32 and torch.equal(sd[key], want), key
    out = _port_forward(port, tb, deterministic=True, render=False)
    assert out["verts"].dtype == torch.float32 and torch.isfinite(out["verts"]).all()


def test_generate_id_cond_on_a_bf16_checkpoint(tmp_path, monkeypatch):
    from ava256_tpu_torch.cli import generate_id_cond
    from ava256_tpu_torch.data.synthetic import write_topology_obj
    from ava256_tpu_torch.train.state import save_checkpoint

    monkeypatch.setenv("AVA256_CACHE_DIR", str(tmp_path / "cache"))
    write_topology_obj(tmp_path / "assets" / "face_topology.obj")
    opts = SHRINK + [f"assets={tmp_path / 'assets'}", "model.dtype=bfloat16"]
    cfg = load_config("configs/config-synthetic.yaml", opts)
    ds = loop.build_dataset(cfg)
    model = loop.build_model(cfg, ds, loop.load_uvdata(cfg), "cpu")
    save_checkpoint(tmp_path / "ckpt", TrainState(model, make_optimizer(model), 0))
    names = generate_id_cond.main(["--config", "configs/config-synthetic.yaml", "--device", "cpu",
                                   "--checkpoint", str(tmp_path / "ckpt"),
                                   "--output", str(tmp_path / "idc"), "--opts"] + opts)
    assert len(names) == len(ds.identities)
    cond = ds.get_neutral_conditioning(0)
    with torch.no_grad():
        want = model.eval().identity_encoder(torch.from_numpy(cond["neut_verts"][None]),
                                             torch.from_numpy(cond["neut_avgtex"][None]))
    with open(tmp_path / "idc" / f"{names[0]}.pkl", "rb") as f:
        got = pickle.load(f)
    assert want["z_geo"].dtype == BF16 and want["b_geo"][0].dtype == torch.float32
    for k in ("z_geo", "z_tex"):
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k].float().numpy())
    for k in ("b_geo", "b_tex"):
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(g, w.numpy())
