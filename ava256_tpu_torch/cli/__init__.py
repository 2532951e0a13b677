# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""The entry points users run, as the JAX package's root scripts:
``python -m ava256_tpu_torch.cli.{train,eval,render,generate_id_cond}``. Each
reads a YAML config plus dotted overrides, takes the same flags as its root
script and ``--device`` (default ``cuda``; without a card it refuses to run
unless ``--device cpu`` is given)."""
