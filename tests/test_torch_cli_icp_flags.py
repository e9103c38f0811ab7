"""Port vs JAX: the ICP scan aligner's selection and multi-scale flags.

Three 6000-point samplings of one height field (scan1 and scan2 offset by a
few cm) through ``icp_scan_aligner.main(..., "--device", "cpu")`` and the
JAX tool, ``-d 0.05 --max_iterations 8``, with ``--number_of_scales 2
--downscale_step 2``, ``--objects_to_optimize scan1,scan2`` (scan0 fixed),
``--objects_to_ignore scan2``, and all three together. Every ``.mlp`` matrix
is held within ``test_torch_cli.MLP_TOL`` (1e-4 per entry) of the JAX
tool's; a fixed or ignored scan keeps its input matrix exactly, and every
other scan but the first moves.
"""

import numpy as np
import pytest
import torch

from dataset_pipeline_tpu.io import meshlab as j_meshlab
from dataset_pipeline_tpu.io import ply as j_ply
from dataset_pipeline_tpu_torch.io import meshlab as t_meshlab

torch.set_num_threads(2)
MLP_TOL = 1e-4  # as tests/test_torch_cli.py
OFFSETS = {"scan0": (0.0, 0.0, 0.0), "scan1": (0.02, -0.015, 0.01), "scan2": (-0.012, 0.018, -0.008)}


def _scan(rng, n=6000):
    u, v = rng.rand(n), rng.rand(n)
    x, y = u * 2, v * 2
    z = 0.12 * np.sin(3 * x) * np.cos(2.5 * y)
    return np.stack([x, y, z], -1).astype(np.float32)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("icp_flags")
    rng = np.random.RandomState(91)
    infos = []
    for label, off in OFFSETS.items():
        j_ply.write_ply(str(root / f"{label}.ply"), j_ply.PointCloud(_scan(rng)))
        M = np.eye(4)
        M[:3, 3] = off
        infos.append(j_meshlab.MeshInfo(label, f"{label}.ply", M))
    j_meshlab.write_meshlab_project(str(root / "in.mlp"), infos)
    return root, {m.label: m.global_T_mesh for m in infos}


@pytest.mark.parametrize("flags,kept", [
    (["--number_of_scales", "2", "--downscale_step", "2"], ()),
    (["--objects_to_optimize", "scan1,scan2"], ("scan0",)),
    (["--objects_to_ignore", "scan2"], ("scan2",)),
    (["--number_of_scales", "2", "--downscale_step", "2", "--objects_to_optimize", "scan1,scan2",
      "--objects_to_ignore", "scan2"], ("scan0", "scan2")),
], ids=["two_scales", "optimize", "ignore", "all_together"])
def test_icp_scan_aligner_flags_match_jax_tool(project, flags, kept):
    from dataset_pipeline_tpu.tools.icp_scan_aligner import main as jax_main
    from dataset_pipeline_tpu_torch.tools.icp_scan_aligner import main as port_main

    root, inputs = project
    name = "_".join(f.strip("-") for f in flags)[:60]
    common = ["-i", str(root / "in.mlp"), "-d", "0.05", "--max_iterations", "8", *flags]
    assert jax_main(common + ["-o", str(root / f"jax_{name}.mlp")]) == 0
    assert port_main(common + ["-o", str(root / f"port_{name}.mlp"), "--device", "cpu"]) == 0
    ref = j_meshlab.read_meshlab_project(str(root / f"jax_{name}.mlp"))
    got = t_meshlab.read_meshlab_project(str(root / f"port_{name}.mlp"))
    assert [m.label for m in got] == [m.label for m in ref] == list(OFFSETS)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.global_T_mesh, b.global_T_mesh, rtol=0, atol=MLP_TOL)
        if a.label in kept:
            np.testing.assert_array_equal(a.global_T_mesh, inputs[a.label])
        elif a.label != "scan0":
            assert np.abs(a.global_T_mesh - inputs[a.label]).max() > 1e-3  # it moved
