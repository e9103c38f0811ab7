"""CubeMapRenderer: 6-face point z-buffer render of a coloured scan.

Port of ``dataset_pipeline_tpu/tools/cube_map_renderer.py`` with the same
flags plus ``--device`` (default ``cuda``; it raises when CUDA is absent
instead of running on the CPU): renders a PLY cloud (in its own scan frame)
into 6 cube faces of ``--size`` px with fx = fy = cx = cy = size/2
(upper-left-corner convention), fills depth holes with the median scheme,
flood-fills the remaining colours, and writes ``<out>.<face>.png`` +
``<out>.<face>.depth`` (raw float32) and ``<out>.intrinsics.txt``.

All six faces go through one batched call of each stage. The face rotations
are signed permutations, so each face's coordinates are exact copies of the
scan's. The JAX tool's u16 log-depth wire encoding (a TPU relay format that
quantizes depth) is not ported: the files come from the exact depths, as the
JAX tool's do on the CPU.

Run: ``python -m dataset_pipeline_tpu_torch.tools.cube_map_renderer -c scan.ply
-o scan.ply --size 2048 [--device cpu]``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from dataset_pipeline_tpu_torch import default_device, resolve_device
from dataset_pipeline_tpu_torch.io.depthmap import write_cube_intrinsics, write_depth_raw
from dataset_pipeline_tpu_torch.io.ply import read_ply
from dataset_pipeline_tpu_torch.ops.splat import (
    CUBE_FACE_NAMES,
    CUBE_FACE_ROTATIONS,
    fill_color_from_depth,
    fill_depth_holes,
    flood_fill_colors,
    render_points_depth_color,
)
from dataset_pipeline_tpu_torch.utils.params import Parameters
from dataset_pipeline_tpu_torch.utils.timing import stage


def face_points(pos):
    """(6,N,3) face-camera coordinates of (N,3) points: row i of a face
    rotation has one entry of +-1, so coordinate i is a signed copy."""
    axis = np.abs(CUBE_FACE_ROTATIONS).argmax(-1)  # (6,3)
    sign = np.take_along_axis(CUBE_FACE_ROTATIONS, axis[..., None], -1)[..., 0]
    axis_t = torch.as_tensor(axis, device=pos.device)
    sign_t = torch.as_tensor(sign, device=pos.device)
    return pos[:, axis_t].permute(1, 0, 2) * sign_t[:, None, :]


def render_cube_map(positions: np.ndarray, colors, size: int, device=None,
                    timings: dict | None = None, stats: dict | None = None):
    """Returns dict face_name -> (depth (S,S) float32, colour (S,S,3) uint8).
    ``timings`` collects ``render``, ``hole_fill`` and ``flood_fill``
    seconds, ``stats`` the flood fill's ``flood_fill_steps`` and
    ``flood_fill_unfilled``."""
    dev = default_device(device)
    pos = torch.as_tensor(np.asarray(positions, np.float32), device=dev)
    if colors is None:
        colors = np.zeros((len(positions), 3), np.uint8)
    cols = torch.as_tensor(np.asarray(colors, np.uint8), device=dev)
    depth, color = render_faces(pos, cols, size, timings, stats)
    depth, color = depth.cpu().numpy(), color.cpu().numpy()
    return {name: (depth[i], color[i]) for i, name in enumerate(CUBE_FACE_NAMES)}


def render_faces(pos, cols, size: int, timings: dict | None = None, stats: dict | None = None):
    """The six faces of (N,3) float32 points with (N,3) uint8 colours on
    their device: (depth (6,S,S) float32, colour (6,S,S,3) uint8), in
    ``CUBE_FACE_NAMES`` order; ``timings`` and ``stats`` as in
    :func:`render_cube_map`."""
    dev = pos.device
    f = size / 2.0
    c = size // 2
    with stage(timings, "render", dev):
        depth_raw, color_raw = render_points_depth_color(face_points(pos), cols, size, size,
                                                         f, f, c, c)
    with stage(timings, "hole_fill", dev):
        depth = fill_depth_holes(depth_raw)
        color, valid = fill_color_from_depth(depth_raw, color_raw)
    with stage(timings, "flood_fill", dev):
        color = flood_fill_colors(color, valid, stats=stats)
    return depth, color


def main(argv=None, timings: dict | None = None, stats: dict | None = None) -> int:
    """Run the tool; ``timings`` collects per-stage seconds (``render``,
    ``hole_fill``, ``flood_fill``, ``writes``), ``stats`` the flood fill's
    counts."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-c", "--cloud", required=True, help="input PLY (scan frame)")
    p.add_argument("-o", "--output", required=True, help="output base path")
    p.add_argument("--size", type=int, required=True, help="face side length in px")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when CUDA is absent")
    # shared pipeline knob set: every tool accepts the identical flags
    Parameters().add_to_argparser(p)
    args = p.parse_args(argv)
    Parameters.from_args(args)
    device = resolve_device(args.device)

    cloud = read_ply(args.cloud)
    print(f"loaded {len(cloud)} points")
    write_cube_intrinsics(
        args.output + ".intrinsics.txt",
        args.size, args.size, args.size // 2, args.size // 2,
        args.size // 2, args.size // 2,
    )
    faces = render_cube_map(cloud.positions, cloud.colors, args.size, device, timings, stats)
    from PIL import Image

    with stage(timings, "writes", device):
        for name, (depth, color) in faces.items():
            Image.fromarray(color).save(f"{args.output}.{name}.png")
            write_depth_raw(f"{args.output}.{name}.depth", depth)
            n_valid = int(np.isfinite(depth).sum())
            print(f"face {name}: {n_valid}/{depth.size} valid depth px")
    return 0


if __name__ == "__main__":
    sys.exit(main())
