"""Port vs JAX: the JointBA CLI (``tools/joint_ba.py``), both routes.

The scenes are ``tests/test_joint_ba_cli.py``'s (``_write_scene``: two
two-scan scenes of 2 images at 128x96 with a perturbed scan-1 ``.mlp`` pose;
``_write_rig_scene``: one scene of 2 frames of a two-camera rig with
``rigs.json``). Their JAX tests are ``slow``, so this file runs the JAX tool
itself (``--devices 1``) beside the port (``--device cpu``) with the same
flags and compares the files:

- every ``.mlp`` entry within 1e-5 (normalized units);
- COLMAP qvec / tvec within 5e-5 per entry, intrinsics within 1e-3 px;
- ``metadata.txt``: the same iterations and row count, the same parameter
  dump, the cost trace within 1e-4 relative.

The LM paths agree in their accept / reject pattern; their float32 steps
differ by the order of the Gram sums (``test_torch_joint_ba.py`` holds the
step within 2 % of its largest entry), which is what the pose bounds
allow for after a few iterations.
"""

import os

import numpy as np
import pytest
import torch

from dataset_pipeline_tpu.io import colmap as jcio
from dataset_pipeline_tpu.io.meshlab import read_meshlab_project
from dataset_pipeline_tpu_torch.parallel import mesh as tmesh
from dataset_pipeline_tpu_torch.tools import image_registrator as treg
from dataset_pipeline_tpu_torch.tools import joint_ba as tjb_tool

torch.set_num_threads(2)
MLP_TOL, Q_TOL, T_TOL, PARAM_TOL, COST_RTOL = 1e-5, 5e-5, 5e-5, 1e-3, 1e-4
COMMON = ["--max_iterations", "3", "--max_corr_distance", "0.1", "--icp_weight", "1.0",
          "--splat_radius", "0.02"]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    import test_joint_ba_cli as jcli

    root = tmp_path_factory.mktemp("joint_ba_cli")
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


def _meta(path):
    lines = open(path).read().splitlines()
    return {l.split(" ", 1)[0]: l.split(" ", 1)[1] for l in lines}


def _compare(a_dir, b_dir, n_scenes):
    for si in range(n_scenes):
        a, b = a_dir / f"scene_{si}", b_dir / f"scene_{si}"
        assert sorted(os.listdir(b)) == sorted(os.listdir(a))
        ma = read_meshlab_project(str(a / "scan_alignment.mlp"))
        mb = read_meshlab_project(str(b / "scan_alignment.mlp"))
        assert [m.filename for m in mb] == [m.filename for m in ma]
        for x, y in zip(ma, mb):
            np.testing.assert_allclose(y.global_T_mesh, x.global_T_mesh, rtol=0, atol=MLP_TOL)
        sa, sb = jcio.read_model(str(a)), jcio.read_model(str(b))
        assert sorted(sa.images) == sorted(sb.images) and sorted(sa.cameras) == sorted(sb.cameras)
        for i in sa.images:
            assert sa.images[i].name == sb.images[i].name
            np.testing.assert_allclose(sb.images[i].qvec, sa.images[i].qvec, rtol=0, atol=Q_TOL)
            np.testing.assert_allclose(sb.images[i].tvec, sa.images[i].tvec, rtol=0, atol=T_TOL)
        for c in sa.cameras:
            np.testing.assert_allclose(sb.cameras[c].params, sa.cameras[c].params, rtol=0,
                                       atol=PARAM_TOL)
        xa, xb = _meta(a / "metadata.txt"), _meta(b / "metadata.txt")
        assert list(xa) == list(xb)
        assert {k: v for k, v in xa.items() if k != "costs"} == \
               {k: v for k, v in xb.items() if k != "costs"}
        ca, cb = (np.asarray(x["costs"].split(), np.float64) for x in (xa, xb))
        assert ca.shape == cb.shape
        np.testing.assert_allclose(cb, ca, rtol=COST_RTOL)
        assert cb[-1] < cb[0]


@pytest.mark.parametrize("route,extra", [("plain", []), ("rig", ["--fix_intrinsics"])])
def test_cli_matches_jax_tool(scenes, route, extra):
    from dataset_pipeline_tpu.tools.joint_ba import main as jax_main

    root, args = scenes
    common = args[route] + COMMON + extra
    assert jax_main(common + ["--output_folder_path", str(root / f"jax_{route}"),
                              "--devices", "1"]) == 0
    assert tjb_tool.main(common + ["--output_folder_path", str(root / f"port_{route}"),
                                   "--device", "cpu"]) == 0
    _compare(root / f"jax_{route}", root / f"port_{route}", len(args[route]) // 2)
    timing = root / f"port_{route}" / "timing.json"
    assert {"build_scene", "pack_scenes", "joint_ba"} <= set(open(timing).read().split('"'))


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


def test_flags_match_jax_tool(monkeypatch):
    from dataset_pipeline_tpu.tools import joint_ba as jax_tool

    jflags, tflags = _flags(jax_tool, monkeypatch), _flags(tjb_tool, monkeypatch)
    assert jflags <= tflags
    assert tflags - jflags == {"--device"}


@pytest.mark.parametrize("flags", [["--devices", "2"], ["--mesh", "1x2"]])
def test_more_than_one_device_is_not_ported(scenes, flags, monkeypatch):
    """More than one device, ported since: the flags make the tool start two
    ranks itself (``tests/test_torch_cli_joint_ba_devices.py`` runs them),
    and nothing raises NotPortedError any more."""
    for k in ("DPT_COORDINATOR", "DPT_NUM_PROCESSES", "DPT_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    root, args = scenes
    parsed, _ = tjb_tool.parse_args(args["plain"] + ["--output_folder_path", str(root / "unused"),
                                                     "--device", "cpu"] + flags)
    assert tmesh.ranks_to_launch(parsed.devices, parsed.mesh, parsed.device) == 2
    assert not hasattr(treg, "NotPortedError")


def test_defaults_to_the_card(scenes, monkeypatch):
    root, args = scenes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tjb_tool.main(args["plain"] + ["--output_folder_path", str(root / "unused")])
