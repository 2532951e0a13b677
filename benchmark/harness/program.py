"""What the benchmark takes from the program (``ava256_tpu_torch``), through
its public modules: the configuration object, the dataset with its camera
hold-out, the topology and its UV maps, the model, the conditioning tables,
the loader and the uploads, the train step and the frame decode. The
model's weights are the benchmark's (``weights.py``), loaded by name."""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Dict

import numpy as np
from ava256_tpu_torch.config import Config
from ava256_tpu_torch.data import write_topology_obj
from ava256_tpu_torch.train import loop

from benchmark.harness import weights


def topology(assets: Path) -> Path:
    """The topology ``.obj`` over the synthetic dataset's vertices: the same
    bytes in every run, written once into the benchmark's cache."""
    path = assets / "face_topology.obj"
    if not path.exists():
        tmp = assets / "face_topology.tmp.obj"
        write_topology_obj(tmp)
        tmp.replace(path)
    return path


def dims(conf: dict, dataset) -> Dict:
    """The reference model's sizes, from the configuration as run and the
    dataset's counts."""
    m, rm = conf["model"], conf["model"]["raymarch"]
    return dict(uv_res=int(conf["data"]["synthetic_texsize"]), nprims=int(m["nprims"]),
                primsize=int(m["primsize"]), nverts=int(dataset.nverts),
                ncams=len(dataset.get_allcameras()), nident=len(dataset.identities),
                volradius=float(m["volradius"]),
                dt=float(rm.get("dt", 1.0)) / float(m["volradius"]), tile=int(rm["tile"]),
                max_hit=int(rm["max_hit"]), nbuf=rm.get("nbuf"),
                cull_group_size=int(rm.get("cull_group_size", 256)),
                cull_max_groups=int(rm.get("cull_max_groups", 8)))


class Program:
    """The program's pieces of one cell, built from its configuration."""

    def __init__(self, conf: dict, assets: Path, device):
        self.conf = copy.deepcopy(conf)
        self.conf["assets"] = str(assets)
        self.cfg = Config.from_nested(self.conf)
        self.device = device
        topology(assets)
        self.dataset = loop.build_dataset(self.cfg)
        self.uvdata = loop.load_uvdata(self.cfg)
        self.dims = dims(self.conf, self.dataset)
        self.model = loop.build_model(self.cfg, self.dataset, self.uvdata, device)

    def load_weights(self, seed: int) -> Dict:
        sd = weights.make(self.dims, seed, self.device)
        self.model.load_state_dict(sd, strict=True)
        return sd


class Indexed:
    """A dataset view whose items also carry their index (``bench_index``),
    so that the benchmark knows which items each batch holds."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        item = self.dataset[idx]
        return None if item is None else dict(item, bench_index=np.int64(idx))
