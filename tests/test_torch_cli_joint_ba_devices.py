"""Port vs JAX: the JointBA CLI on two ranks, both routes.

The scenes of ``tests/test_torch_cli_joint_ba.py`` (``test_joint_ba_cli.py``'s
two two-scan scenes of 2 images, and its two-frame rig scene) through the
JAX tool and through the port on the CPU with the same multi-device flags:
the plain route at ``--devices 2`` (two of the four images a rank), the
rig route at ``--mesh 2x1`` (one frame a rank); the port starts its two Gloo
ranks itself and rank 0 alone writes. The files are held to the one-device
parity test's bounds (``test_torch_cli_joint_ba._compare``: ``.mlp`` 1e-5,
qvec / tvec 5e-5, intrinsics 1e-3 px, the same metadata, the cost trace
1e-4 relative).
"""

import numpy as np
import pytest
import torch

import test_torch_cli_joint_ba as tcj
from dataset_pipeline_tpu_torch.tools import joint_ba as tjb_tool

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    import test_joint_ba_cli as jcli

    root = tmp_path_factory.mktemp("joint_ba_cli_devices")
    rng = np.random.RandomState(5)
    plain = []
    for si, phase in enumerate([0.0, 0.7]):
        jcli._write_scene(str(root / f"scene{si}"), 10 * (si + 1), phase,
                          0.01 * rng.randn(6).astype(np.float32))
        d = root / f"scene{si}"
        plain += ["--scene", f"{d}/scan_alignment.mlp,{d}/state,{d}/images"]
    jcli._write_rig_scene(str(root / "rig"), 10, 0.0,
                          0.008 * np.random.RandomState(5).randn(6).astype(np.float32),
                          np.asarray([-0.06, 0.0, 0.0]))
    d = root / "rig"
    rig = ["--scene", f"{d}/scan_alignment.mlp,{d}/state,{d}/images"]
    return root, {"plain": plain, "rig": rig}


@pytest.mark.parametrize("route,flags", [("plain", ["--devices", "2"]),
                                         ("rig", ["--mesh", "2x1", "--fix_intrinsics"])])
def test_two_ranks_match_the_jax_tool(scenes, route, flags):
    from dataset_pipeline_tpu.tools.joint_ba import main as jax_main

    root, args = scenes
    common = args[route] + tcj.COMMON + flags
    assert jax_main(common + ["--output_folder_path", str(root / f"jax_{route}")]) == 0
    assert tjb_tool.main(common + ["--output_folder_path", str(root / f"port_{route}"),
                                   "--device", "cpu"]) == 0
    tcj._compare(root / f"jax_{route}", root / f"port_{route}", 2 if route == "plain" else 1)
