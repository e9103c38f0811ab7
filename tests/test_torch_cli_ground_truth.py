"""Port vs JAX: the GroundTruthCreator CLI, every output file compared.

One small scene (``synthetic.write_scene``'s ray-cast height field, three
96x72 images, two scans: the first scan's points under a tilted pose, the
second's under the identity), through
``ground_truth_creator.main(..., "--device", "cpu")`` and the JAX tool:

- the defaults (splat occlusion at every scan point);
- ``--occlusion_mesh_path`` (a grid mesh of the surface) with
  ``--occlusion_splats_path`` (two quads in front of it), writing the
  occlusion depth;
- ``--rotate_first_scan_upright --compress_depth_maps 1
  --write_occlusion_depth 1 --write_scan_renderings 1`` with the images;
- an eval mask holding ``MASK_EVAL_OBS`` pixels (and ``MASK_OBS`` ones,
  which do not exclude), with ``--occlusion_splats_path`` alone.

Compared: the same set of files; every depth map (raw, or the decompressed
payload of a ``.gz``: the gzip header holds a time and a name) and the
kept-point clouds bit for bit; ``scan_alignment.mlp`` and ``calibration/``
as text; scan renderings pixel for pixel. The port rotates and projects the
points in the fused forms XLA gives the JAX tool's ``jit`` functions, and
computes the poses op by op as the JAX tool does, so nothing needs a
tolerance.
"""

import gzip
import os

import numpy as np
import pytest
import torch
from PIL import Image

from dataset_pipeline_tpu.tools import ground_truth_creator as jgt
from dataset_pipeline_tpu_torch.io.meshlab import MeshInfo, write_meshlab_project
from dataset_pipeline_tpu_torch.io.ply import PointCloud, read_ply, write_ply
from dataset_pipeline_tpu_torch.photometric.masks import MASK_EVAL_OBS, MASK_OBS
from dataset_pipeline_tpu_torch.tools import ground_truth_creator as tgt
from dataset_pipeline_tpu_torch.utils import synthetic

torch.set_num_threads(2)
W, H, F = 96, 72, 80.0


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("gt_scene")
    tq, tt = synthetic.write_scene(str(root), W, H, F, 3, 6000, seed=3, device="cpu")
    synthetic.write_state(str(root / "state_true"), tq, tt)
    scan = read_ply(str(root / "scan.ply"))
    # scan 0 under a tilted pose whose inverse is applied to its points (the
    # same world points), scan 1 under the identity
    a, b = 0.05, -0.03
    Rz = np.asarray([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    Rx = np.asarray([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    M0 = np.eye(4)
    M0[:3, :3], M0[:3, 3] = Rz @ Rx, [0.02, -0.01, 0.03]
    half = len(scan.positions) // 2
    p0 = (scan.positions[:half] - M0[:3, 3]) @ M0[:3, :3]
    write_ply(str(root / "scan0.ply"), PointCloud(p0.astype(np.float32), None, scan.colors[:half]))
    write_ply(str(root / "scan1.ply"), PointCloud(scan.positions[half:], None, scan.colors[half:]))
    write_meshlab_project(str(root / "two.mlp"), [MeshInfo("scan0", "scan0.ply", M0),
                                                  MeshInfo("scan1", "scan1.ply", np.eye(4))])
    half_w, half_h = synthetic.scan_extent(W, H, F, 3, synthetic.DEPTH, 0.15)
    verts, faces = synthetic.surface_mesh(half_w, half_h, 0.1, synthetic.DEPTH)
    write_ply(str(root / "mesh.ply"), PointCloud(verts, faces=faces))
    # two quads 1 m in front of the surface
    quad = np.asarray([[-0.5, -0.3, 4.0], [0.0, -0.3, 4.0], [0.0, 0.2, 4.0], [-0.5, 0.2, 4.0]])
    sv = np.concatenate([quad, quad + [0.8, 0.1, 0.2]]).astype(np.float32)
    sf = np.asarray([[2, 1, 0], [0, 3, 2], [6, 5, 4], [4, 7, 6]], np.int32)
    write_ply(str(root / "splats.ply"), PointCloud(sv, faces=sf))
    # eval mask of image 1: MASK_EVAL_OBS on a band, MASK_OBS on another
    mask = np.zeros((H, W), np.uint8)
    mask[:, 10:40] = MASK_EVAL_OBS
    mask[50:, :] = MASK_OBS
    os.makedirs(root / "masked" / "masks_for_images")
    Image.fromarray(mask).save(root / "masked" / "masks_for_images" / "img001.png")
    return root


def _files(root):
    out = []
    for d, _, fs in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in fs]
    return sorted(out)


def _payload(path):
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def assert_same_outputs(jdir, tdir):
    assert _files(tdir) == _files(jdir)
    for rel in _files(jdir):
        jp, tp = os.path.join(jdir, rel), os.path.join(tdir, rel)
        if rel.endswith(".ply"):
            jc, tc = read_ply(jp), read_ply(tp)
            np.testing.assert_array_equal(tc.positions, jc.positions, err_msg=rel)
            np.testing.assert_array_equal(tc.colors, jc.colors, err_msg=rel)
        elif rel.startswith("scan_rendering"):
            np.testing.assert_array_equal(np.asarray(Image.open(tp)), np.asarray(Image.open(jp)),
                                          err_msg=rel)
        else:  # depth maps (raw / gz payload), .mlp, COLMAP text
            assert _payload(tp) == _payload(jp), rel


CASES = {
    "defaults": [],
    "mesh_and_splats": ["--occlusion_mesh_path", "{root}/mesh.ply",
                        "--occlusion_splats_path", "{root}/splats.ply",
                        "--write_occlusion_depth", "1"],
    "upright_compressed_renderings": ["--rotate_first_scan_upright", "--compress_depth_maps", "1",
                                      "--write_occlusion_depth", "1",
                                      "--write_scan_renderings", "1",
                                      "--image_base_path", "{root}/images"],
    "eval_mask_splats": ["--image_base_path", "{root}/masked",
                         "--occlusion_splats_path", "{root}/splats.ply"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ground_truth_creator_matches_jax(scene, case):
    root = str(scene)
    extra = [a.format(root=root) for a in CASES[case]]
    args = ["--scan_alignment_path", f"{root}/two.mlp", "--state_path", f"{root}/state_true",
            "--splat_radius", "0.05", *extra]
    jdir, tdir = f"{root}/{case}_jax", f"{root}/{case}_torch"
    assert jgt.main(args + ["--output_folder_path", jdir]) == 0
    assert tgt.main(args + ["--output_folder_path", tdir, "--device", "cpu"]) == 0
    assert_same_outputs(jdir, tdir)
    gt = [f for f in _files(tdir) if f.startswith("ground_truth_depth")]
    assert len(gt) == 3
    d = np.fromfile(os.path.join(tdir, gt[0]), np.float32) if not gt[0].endswith(".gz") else \
        np.frombuffer(_payload(os.path.join(tdir, gt[0])), np.float32)
    assert np.isfinite(d).mean() > 0.2  # the scene is seen
    if case == "upright_compressed_renderings":
        assert any(f.startswith("scan_rendering") for f in _files(tdir))


def test_ground_truth_creator_needs_cuda_unless_cpu(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = str(scene)
    with pytest.raises(RuntimeError, match="cuda"):
        tgt.main(["--scan_alignment_path", f"{root}/two.mlp", "--state_path",
                  f"{root}/state_true", "--output_folder_path", f"{root}/never"])


TOOLS = ("ground_truth_creator", "cube_map_renderer", "sfm_scale_estimator", "normal_estimator",
         "splat_creator")


class _Parsed(Exception):
    pass


def _flags(module, monkeypatch):
    """The option strings of a tool's parser (its ``main`` stops at parsing)."""
    import argparse

    seen = {}

    def grab(self, args=None, namespace=None):
        seen["flags"] = {s for a in self._actions for s in a.option_strings}
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        module.main([])
    monkeypatch.undo()
    return seen["flags"]


@pytest.mark.parametrize("tool", TOOLS)
def test_tools_accept_every_flag_of_the_jax_tool(tool, monkeypatch):
    import importlib

    jflags = _flags(importlib.import_module(f"dataset_pipeline_tpu.tools.{tool}"), monkeypatch)
    tflags = _flags(importlib.import_module(f"dataset_pipeline_tpu_torch.tools.{tool}"), monkeypatch)
    assert jflags <= tflags, sorted(jflags - tflags)
    # the device tools add --device; the host-only SfM estimator adds nothing
    assert tflags - jflags == (set() if tool == "sfm_scale_estimator" else {"--device"})


@pytest.mark.parametrize("tool", ["cube_map_renderer", "normal_estimator", "splat_creator"])
def test_device_tools_default_to_the_card(tool, tmp_path, monkeypatch):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"dataset_pipeline_tpu_torch.tools.{tool}")
    args = {"cube_map_renderer": ["-c", "x.ply", "-o", "x", "--size", "8"],
            "normal_estimator": ["-i", "x.mlp", "-o", "x.ply"],
            "splat_creator": ["--point_normal_cloud_path", "x.ply", "--mesh_path", "m.ply",
                              "--output_path", "o.ply"]}[tool]
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main(args)
