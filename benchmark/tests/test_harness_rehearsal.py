"""Whole runs on the CPU at the configurations' rehearsal sizes (the plain
versions of the program's kernels): a cell added by new files and entries
alone (a configuration, a mix with a loop of its own, limits, a metric)
runs and reports its new metric; a run with the timed path broken
underneath comes out not correct, once for each fault a cell can have; a
run with no card and no ``--device cpu`` refuses to run."""

import json
import shutil

import pytest
import torch

from benchmark.harness import cli
from benchmark.harness import spec as S


def _run(capsys, argv):
    rc = cli.main(argv, 0.0)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)


@pytest.fixture
def isolated(tmp_path, monkeypatch):
    """The benchmark's data files copied under a temporary root, which the
    harness then reads, with its caches there too."""
    root = tmp_path / "root"
    bench = root / "benchmark"
    for sub in ("configs", "traffic", "loops", "limits", "metrics"):
        shutil.copytree(S.BENCH_DIR / sub, bench / sub)
    shutil.copy(S.SPEC_FILE, root / "BENCHMARK.json")
    monkeypatch.setattr(S, "ROOT", root)
    monkeypatch.setattr(S, "BENCH_DIR", bench)
    monkeypatch.setattr(S, "SPEC_FILE", root / "BENCHMARK.json")
    monkeypatch.setattr(cli, "CACHE", tmp_path / "cache")
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return root


# limits for the CPU rehearsal's train cells alone (plain kernels at tiny
# sizes; sound runs read at most 8e-5, 5e-5 and 3.3e-3, half a batch left
# out 0.61, 3.1 and 0.30, a state left unchanged a change gap of 1)
REHEARSAL_TRAIN_LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 3e-2}


def _add_train_cell(root, name, config="flagship", traffic="train_steady"):
    """A training cell added by entries and a limits file alone."""
    bench = root / "benchmark"
    (bench / "limits" / f"{name}.json").write_text(json.dumps(REHEARSAL_TRAIN_LIMITS))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append(dict(name=name, config=config, traffic=traffic, chips=1,
                                  why="a training cell of the rehearsal"))
    rate = [m for m in spec["end_to_end"] if m["name"] == "train_images_per_s"]
    if not rate:
        rate = [dict(name="train_images_per_s", unit="images/s", better="higher", bound=0.25,
                     source="host_clock", workloads=[])]
        spec["end_to_end"].insert(0, rate[0])
    rate[0]["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return spec


def test_a_new_cell_from_files_and_entries_alone(isolated, capsys):
    root = isolated
    bench = root / "benchmark"
    conf = json.loads((bench / "configs" / "flagship.json").read_text())
    conf["config"]["train"]["losses"] = {"irgbl1": 1.0, "vertl1": 0.1}
    (bench / "configs" / "flagship_l1.json").write_text(json.dumps(conf))
    mix = json.loads((bench / "traffic" / "train_steady.json").read_text())
    mix.update(checked_steps=2, loop="train_counted")
    (bench / "traffic" / "train_short.json").write_text(json.dumps(mix))
    (bench / "loops" / "train_counted.py").write_text(
        "from benchmark.harness import spec\n"
        "readings = spec.loop('train').readings\n\n\n"
        "def run(r):\n"
        "    res = spec.loop('train').run(r)\n"
        "    res['records']['steps_counted'] = res['attempted']\n"
        "    return res\n")
    (bench / "metrics" / "steps_seen.train.py").write_text(
        "def read(rec):\n    return float(rec['steps_counted'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="flagship_l1",
                                file="benchmark/configs/flagship_l1.json"))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    spec = _add_train_cell(root, "flagship_l1.short", config="flagship_l1",
                           traffic="train_short")
    spec["per_layer"].append(dict(name="steps_seen.train", unit="steps", better="higher",
                                  source="host_clock", layer="loop",
                                  moves="train_images_per_s", workloads=["flagship_l1.short"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, line = _run(capsys, ["--workload", "flagship_l1.short", "--seed", "2147483700",
                             "--seconds", "1", "--trace", "1", "--device", "cpu"])
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["steps_seen.train"]["value"] >= 1
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap"}


def _no_update(monkeypatch):
    from ava256_tpu_torch.train import state

    monkeypatch.setattr(state.Optimizer, "step", lambda self, step: None)


def _half_batch(monkeypatch):
    from ava256_tpu_torch.train import step

    full = step.expand_batch

    def half(batch, cond):
        out = full(batch, cond)
        n = out["image"].shape[0] // 2
        return {k: v[:n] for k, v in out.items()}

    monkeypatch.setattr(step, "expand_batch", half)


def _altered_image(monkeypatch):
    from ava256_tpu_torch import render

    decode = render.decode

    def altered(*args, **kwargs):
        return decode(*args, **kwargs) * 1.01

    monkeypatch.setattr(render, "decode", altered)


@pytest.mark.parametrize("cell, fault", [
    ("flagship.train", _no_update),
    ("flagship.train", _half_batch),
    ("flagship.render", _altered_image),
], ids=["state_unchanged", "half_batch", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(isolated, capsys, monkeypatch, cell, fault):
    if cell.endswith(".train"):
        _add_train_cell(isolated, cell)
    fault(monkeypatch)
    rc, line = _run(capsys, ["--workload", cell, "--seed", "91", "--seconds", "1",
                             "--trace", "0", "--device", "cpu"])
    assert rc == 0 and line["correct"] is False


def test_no_card_no_result(isolated, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, line = _run(capsys, ["--workload", "flagship.render", "--seed", "1", "--seconds", "1",
                             "--trace", "0"])
    assert rc != 0 and line is None
