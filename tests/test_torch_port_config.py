# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The port's config system (``ava256_tpu_torch.config``) against PyYAML and
the JAX package's ``ava256_tpu.config``: equal values.

- ``load_config`` on every ``configs/*.yaml`` equals ``yaml.safe_load``;
- plain scalars resolve as ``safe_load`` resolves them (YAML 1.1: yes/on
  are booleans, ``1e-3`` without a dot is a string);
- ``merge_dotted`` gives what the JAX one gives on each override, and warns
  on the same unknown keys;
- YAML outside the subset raises instead of being guessed at.
"""

import glob
import logging

import pytest
import yaml

from ava256_tpu_torch.config import (
    Config, YamlSubsetError, load_config, parse_yaml, resolve_scalar)

from tests import _torch_port_threads  # noqa: F401
from ava256_tpu.config import Config as JaxConfig
from ava256_tpu.config import load_config as jax_load_config

CONFIGS = sorted(glob.glob("configs/*.yaml"))


def _same(a, b):
    """Equal values of equal types (True is not 1), nan equal to nan."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and a != a:
        return isinstance(b, float) and b != b
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.split("/")[-1])
def test_load_config_equals_safe_load(path):
    with open(path) as f:
        ref = yaml.safe_load(f)
    cfg = load_config(path)
    assert isinstance(cfg, Config) and _same(cfg.to_dict(), ref)
    assert _same(cfg.to_dict(), jax_load_config(path).to_dict())
    assert cfg.model.raymarch.backend == ref["model"]["raymarch"]["backend"]


SCALARS = ["yes", "No", "on", "OFF", "true", "False", "~", "null", "NULL", "0", "-0", "007",
           "08", "0x1F", "0b101", "1_000", "+12", "1:30", "1.0e-3", "2.0e-4", "1e-3", "1.e5",
           ".5", "1.", "-3.25", "+.inf", "-.inf", ".nan", "1:30.5", "abc", "-foo", "a b",
           "pallas", "run/", "0o7", "1e+3"]


@pytest.mark.parametrize("text", SCALARS)
def test_plain_scalars_resolve_as_safe_load(text):
    assert _same(resolve_scalar(text), yaml.safe_load(text))


def test_parser_reads_the_subset():
    text = ('a:\n  b: "x # not a comment"  # a comment\n  c: \'it\'\'s\'\n'
            '  d: [1, "two", [3.5, null], true]\n  e:\n  f: []\n# trailing\n'
            'g: 2.0e-4\nh: "a\\tb\\\\c \\"q\\""\n')
    assert _same(parse_yaml(text), yaml.safe_load(text))
    assert parse_yaml("# nothing\n") is None


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n  - 2\n",           # block sequence
    "a: {b: 1}\n",                  # flow mapping
    "a: &x 1\nb: *x\n",             # anchor and alias
    "a: !!str 1\n",                 # tag
    "a: |\n  text\n",               # block scalar
    "a: [1,\n  2]\n",               # multi-line flow list
    "a: 2001-12-14\n",              # timestamp
    "---\na: 1\n",                  # document marker
    "a:\n  b: 1\n c: 2\n",          # indentation that matches no parent
    "a: 1\na: 2\n",                 # duplicate key
    "a: b: c\n",                    # mapping on one line
    'a: "\\u00e9"\n',               # unicode escape
])
def test_parser_refuses_what_it_does_not_read(text):
    with pytest.raises(YamlSubsetError):
        parse_yaml(text)


OVERRIDES = ["model.bgmodel=false", "train.checkpoint=null", "model.lr=1e-3",
             "mesh.axes=[1,2]", "model.colorcal=yes", "progress.output_path=\"run x/\"",
             "train.maxiter=20", "model.raymarch.backend=reference", "data.synthetic=off",
             "train.outdir=foo", "new.section.key=1.5"]


@pytest.mark.parametrize("override", OVERRIDES)
def test_merge_dotted_matches_jax(override, caplog):
    base = {"model": {"bgmodel": True, "colorcal": True, "lr": 1.0,
                      "raymarch": {"backend": "pallas"}},
            "train": {"checkpoint": "", "maxiter": 10}, "mesh": {"axes": ["data"]},
            "progress": {"output_path": "run/"}, "data": {"synthetic": True}}
    with caplog.at_level(logging.WARNING):
        ref = JaxConfig.from_nested(base).merge_dotted([override]).to_dict()
    jax_warned = [r.getMessage() for r in caplog.records]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        got = Config.from_nested(base).merge_dotted([override]).to_dict()
    assert _same(got, ref)
    assert [r.getMessage() for r in caplog.records] == jax_warned
    assert bool(jax_warned) == (override.split("=")[0] in ("train.outdir", "new.section.key"))


def test_merge_dotted_takes_key_value_pairs():
    cfg = Config.from_nested({"train": {"maxiter": 1, "nids": 2}})
    cfg.merge_dotted(["train.maxiter", "7", "train.nids=3"])
    assert cfg.train.maxiter == 7 and cfg.train.nids == 3
