"""``BENCHMARK.json`` against the benchmark's contract: every entry resolves
to its files, names and units use only the allowed characters, each
per-layer metric moves an end-to-end metric that every cell it lists
reports, and the run length fits the full check."""

import json
import re

import pytest

from benchmark.harness import spec as S

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = S.load_spec()
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_keys_and_limits():
    assert set(SPEC) == TOP
    assert 1 <= len(SPEC["paths"]) <= 16 and all(not p.startswith("/") and ".." not in p
                                                 for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and SPEC["command"][1].startswith(SPEC["paths"][0] + "/")
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(SPEC["configs"]) <= 24
    # a full check with the 24 cells later PRs may add: 2 + 14 x 24 runs
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_configs_resolve(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and all(NAME.match(k) for k in cfg["reduced"])
    assert cfg["file"].startswith(SPEC["paths"][0] + "/")
    body = json.loads((S.ROOT / cfg["file"]).read_text())
    assert body["source"] == cfg["source"] and body["reduced"] == cfg["reduced"]
    assert 1 <= len(cfg["source"]) <= 200 and 1 <= len(cfg["why"]) <= 200
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cells_resolve(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    S.config_of(SPEC, cell)
    loop = S.loop(S.traffic_of(cell)["loop"])
    assert callable(loop.run) and callable(loop.readings)
    assert S.limits_of(cell)
    e2e = {m["name"] for m in S.metrics_of(SPEC, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    per = S.metrics_of(SPEC, cell, "per_layer")
    assert per
    for m in per:
        assert callable(S.reader(m["name"]))


def test_pairs_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for group in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_fields(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(m.get("workloads", [])) <= cells
    if m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_where_listed(m):
    e2e = {x["name"]: x for x in SPEC["end_to_end"]}
    assert m["moves"] in e2e and m["moves"] != "setup_s"
    for cell in m.get("workloads", [w["name"] for w in SPEC["workloads"]]):
        assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_every_cell_has_a_setup_bound_of_its_own():
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0] and setup[0]["bound"] <= 0.25
