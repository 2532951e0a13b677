# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Train the universal codec avatar autoencoder, as ``train.py``:

    python -m ava256_tpu_torch.cli.train --config configs/config-synthetic-flagship.yaml \\
        assets=DIR train.maxiter=N

Data-parallel over N devices, one process each (``train.batchsize`` items
per process and step)::

    torchrun --nproc_per_node N -m ava256_tpu_torch.cli.train --config ... mesh.multihost=true

(``--device cpu`` trains the ranks on the CPU over gloo.) YAML config +
dotted overrides (``--opts a.b=c ...`` or inline); see ``train.loop`` for
what a run does. ``assets`` names the directory that holds
``face_topology.obj`` (``data.synthetic.write_topology_obj`` writes one for
the synthetic dataset).
"""

from __future__ import annotations

import argparse

from ava256_tpu_torch.cli.common import add_device_arg
from ava256_tpu_torch.config import load_config
from ava256_tpu_torch.train.loop import run
from ava256_tpu_torch.utils import setup_logging


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train an avatar autoencoder")
    parser.add_argument("--config", default="configs/config.yaml")
    parser.add_argument("--opts", default=[], nargs="+")
    parser.add_argument("opts_inline", nargs="*", help="dotted key=value overrides")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    cfg = load_config(args.config, list(args.opts) + list(args.opts_inline))
    setup_logging()
    return run(cfg, device=args.device)


if __name__ == "__main__":
    main()
