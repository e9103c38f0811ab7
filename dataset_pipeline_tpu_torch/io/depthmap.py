"""Copy of ``dataset_pipeline_tpu/io/depthmap.py`` (numpy only): importing the
JAX package would import jax, which the port must not.

Raw-float depth map I/O (+ cube-map intrinsics sidecar).

Counterpart of the reference's depth outputs: row-major float32 with no
header, optionally gzip-compressed at level 8
(``exe/ground_truth_creator.cc:136-145``, ``exe/cube_map_renderer.cc:384-393``)
and the ``.intrinsics.txt`` sidecar (``exe/cube_map_renderer.cc:148-158``).
"""

from __future__ import annotations

import gzip
from typing import Tuple

import numpy as np


def write_depth_raw(path: str, depth: np.ndarray, compress: bool = False) -> str:
    depth = np.ascontiguousarray(depth, np.float32)
    if compress:
        path = path if path.endswith(".gz") else path + ".gz"
        with gzip.open(path, "wb", compresslevel=8) as f:
            f.write(depth.tobytes())
    else:
        depth.tofile(path)
    return path


def read_depth_raw(path: str, height: int, width: int) -> np.ndarray:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            buf = f.read()
        arr = np.frombuffer(buf, np.float32)
    else:
        arr = np.fromfile(path, np.float32)
    if arr.size != height * width:
        raise ValueError(f"{path}: expected {height*width} floats, got {arr.size}")
    return arr.reshape(height, width)


def write_cube_intrinsics(path: str, width: int, height: int, fx: float, fy: float,
                          cx: float, cy: float) -> None:
    with open(path, "w") as f:
        f.write("# Cube map face image intrinsics in the format: width height fx fy cx cy\n")
        f.write(
            "# For the principal point the convention having pixel coordinates (0, 0) at "
            "the top left corner of the image (instead of the center of the top left pixel) "
            "is used.\n"
        )
        f.write(f"{width} {height} {fx:.9g} {fy:.9g} {cx:.9g} {cy:.9g}")


def read_cube_intrinsics(path: str) -> Tuple[int, int, float, float, float, float]:
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                w, h, fx, fy, cx, cy = line.split()
                return int(w), int(h), float(fx), float(fy), float(cx), float(cy)
    raise ValueError(f"{path}: no data line")
