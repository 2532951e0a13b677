# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Camera calibration (KRT JSON) loading, host side, numpy only: the port's
own copy of ``ava256_tpu.geometry.krt``.

The on-disk format is a JSON file with a top-level "KRT" list; each entry has
"cameraId", a 4x3 "T" (the [R|t] world-to-camera extrinsics, stored
transposed), a 3x3 "K" (stored transposed) and radial-tangential
"distortion" coefficients. Intrinsics are at the release's full resolution,
4096 x 2668.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Union

import numpy as np


def load_camera_calibration(path: Union[str, Path]) -> Dict[str, Dict[str, np.ndarray]]:
    """Load a KRT file containing per-camera calibration.

    Returns a dict keyed by camera id with:
        intrin: [3,3] intrinsics
        extrin: [3,4] world-to-camera extrinsics [R|t]
        dist:   distortion coefficients (radial-tangential, padded)
        model/height/width: metadata
    """
    with open(path, "r") as f:
        camera_list = json.load(f)["KRT"]

    cameras: Dict[str, Dict[str, np.ndarray]] = {}
    for item in camera_list:
        rt = np.array(item["T"])[:4, :3].T
        cameras[item["cameraId"]] = {
            "intrin": np.array(item["K"]).T,
            "extrin": rt,
            "dist": np.array(item["distortion"] + [0.0]),
            "model": "radial-tangential",
            "height": 4096,
            "width": 2668,
        }
    return cameras


def camera_params(
    krt: Dict[str, np.ndarray], downsample: int = 1
) -> Dict[str, np.ndarray]:
    """A KRT entry as (campos, camrot, focal, princpt) float32 arrays, the
    intrinsics divided by ``downsample``."""
    extrin = krt["extrin"]
    intrin = krt["intrin"]
    return {
        "campos": (-extrin[:3, :3].T @ extrin[:3, 3]).astype(np.float32),
        "camrot": extrin[:3, :3].astype(np.float32),
        "focal": (np.diag(intrin[:2, :2]) / downsample).astype(np.float32),
        "princpt": (intrin[:2, 2] / downsample).astype(np.float32),
    }
