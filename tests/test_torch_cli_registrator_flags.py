"""Port vs JAX: the ImageRegistrator CLI with several camera groups and flags.

A scene of four images (``synthetic.write_scene``'s ray-cast height field)
in three camera groups: PINHOLE 640x480 (images 1, 2), OPENCV 640x480 with
zero distortion (image 3) and PINHOLE 320x240 at half the focal length
(image 4, re-rendered at that size: its pyramid has one scale fewer, so the
group starts at ``min_image_scale`` 1 and its first scale runs sample one
pyramid level). Image 1 has an observation mask
(``masks_for_images/img000.png``), and the occlusion points come from
``--occlusion_splats_path`` (every second scan point). Through
``image_registrator.main(..., "--device", "cpu")`` and the JAX tool,
``--max_iterations 2``:

- the three groups, the mask and the splats with the default scales;
- ``--fix_intrinsics --target_scaling_factor 0.5``;
- ``--camera_ids_to_ignore 3 --initial_scaling_factor 0.5
  --variable_residuals_weight 0``.

Held to the tolerances of ``test_torch_image_registrator.py``: the same
``scale_*_state`` directories and camera ids, qvec and tvec 5e-7 per entry,
intrinsics 1e-3 px (with ``--fix_intrinsics`` exactly the JAX tool's, the input
rounded to float32),
optimum cost 1e-4 relative.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from dataset_pipeline_tpu.io import colmap as jcio
from dataset_pipeline_tpu_torch.io import colmap as tcio
from dataset_pipeline_tpu_torch.io.image import write_pgm
from dataset_pipeline_tpu_torch.io.ply import PointCloud, read_ply, write_ply
from dataset_pipeline_tpu_torch.utils import synthetic

torch.set_num_threads(2)
Q_TOL, T_TOL, PARAM_TOL, COST_RTOL = 5e-7, 5e-7, 1e-3, 1e-4  # as test_torch_image_registrator.py
W, H, F = 640, 480, 2800.0 * 640 / 3072


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("registrator_flags")
    tq, tt = synthetic.write_scene(str(root), W, H, F, 4, 10_000, seed=5, device="cpu")
    # image 4 again at 320x240 with half the focal length
    w2, h2, f2 = W // 2, H // 2, F / 2
    img = synthetic.render(torch.as_tensor(tq[3]), torch.as_tensor(tt[3]), w2, h2, f2,
                           (w2 - 1) / 2.0, (h2 - 1) / 2.0, synthetic.DEPTH)
    write_pgm(str(root / "images" / "img003.pgm"),
              torch.clamp(torch.round(img), 0, 255).to(torch.uint8).numpy())
    model = tcio.read_model(str(root / "state"))
    cx, cy = W / 2.0, H / 2.0  # COLMAP's principal point: (W - 1) / 2 + 0.5
    model.cameras = {
        1: tcio.ColmapCamera(1, "PINHOLE", W, H, np.asarray([F, F, cx, cy])),
        2: tcio.ColmapCamera(2, "OPENCV", W, H, np.asarray([F, F, cx, cy, 0.0, 0.0, 0.0, 0.0])),
        3: tcio.ColmapCamera(3, "PINHOLE", w2, h2, np.asarray([f2, f2, w2 / 2.0, h2 / 2.0])),
    }
    model.images[3].camera_id = 2
    model.images[4].camera_id = 3
    tcio.write_model(str(root / "state"), model)
    mask = np.zeros((H, W), np.uint8)
    mask[:, : W // 4] = 1  # no observations in the left quarter of image 1
    os.makedirs(root / "images" / "masks_for_images")
    Image.fromarray(mask).save(root / "images" / "masks_for_images" / "img000.png")
    scan = read_ply(str(root / "scan.ply"))
    write_ply(str(root / "splats.ply"), PointCloud(np.ascontiguousarray(scan.positions[::2])))
    return root


def _args(root, out, extra):
    return ["--scan_alignment_path", str(root / "scene.mlp"),
            "--image_base_path", str(root / "images"), "--state_path", str(root / "state"),
            "--output_folder_path", str(root / out), "--max_iterations", "2",
            "--occlusion_splats_path", str(root / "splats.ply"), *extra]


def _meta(path):
    return dict(line.split(" ", 1) for line in open(path).read().splitlines())


@pytest.mark.parametrize("extra", [
    [],
    ["--fix_intrinsics", "--target_scaling_factor", "0.5"],
    ["--camera_ids_to_ignore", "3", "--initial_scaling_factor", "0.5",
     "--variable_residuals_weight", "0"],
], ids=["three_groups_mask_splats", "fix_intrinsics", "ignore_camera"])
def test_image_registrator_flags_match_jax_tool(scene, extra):
    from dataset_pipeline_tpu.tools.image_registrator import main as jax_main
    from dataset_pipeline_tpu_torch.tools.image_registrator import main as port_main

    name = "_".join(x.strip("-") for x in extra) or "default"
    assert jax_main(_args(scene, f"jax_{name}", extra)) == 0
    assert port_main(_args(scene, f"port_{name}", extra + ["--device", "cpu"])) == 0
    init = jcio.read_model(str(scene / "state"))
    scales = sorted(d for d in os.listdir(scene / f"jax_{name}") if d.startswith("scale_"))
    assert scales and scales == sorted(d for d in os.listdir(scene / f"port_{name}")
                                       if d.startswith("scale_"))
    ignored = {3} if "--camera_ids_to_ignore" in extra else set()
    for d in scales:
        a = jcio.read_model(str(scene / f"jax_{name}" / d))
        b = jcio.read_model(str(scene / f"port_{name}" / d))
        assert sorted(a.cameras) == sorted(b.cameras) == sorted(set(init.cameras) - ignored)
        assert sorted(a.images) == sorted(b.images)
        for i in a.images:
            assert a.images[i].name == b.images[i].name
            np.testing.assert_allclose(b.images[i].qvec, a.images[i].qvec, rtol=0, atol=Q_TOL)
            np.testing.assert_allclose(b.images[i].tvec, a.images[i].tvec, rtol=0, atol=T_TOL)
        for c in a.cameras:
            assert (b.cameras[c].model, b.cameras[c].width, b.cameras[c].height) == (
                a.cameras[c].model, a.cameras[c].width, a.cameras[c].height)
            np.testing.assert_allclose(b.cameras[c].params, a.cameras[c].params, rtol=0,
                                       atol=PARAM_TOL)
            if "--fix_intrinsics" in extra:  # the input's, rounded to float32 by both tools
                np.testing.assert_array_equal(b.cameras[c].params, a.cameras[c].params)
                np.testing.assert_allclose(b.cameras[c].params, init.cameras[c].params, rtol=1e-7)
        ma = _meta(scene / f"jax_{name}" / d / "metadata.txt")
        mb = _meta(scene / f"port_{name}" / d / "metadata.txt")
        assert list(ma) == list(mb)
        assert {k: v for k, v in ma.items() if k != "optimum_cost"} == \
               {k: v for k, v in mb.items() if k != "optimum_cost"}
        np.testing.assert_allclose(float(mb["optimum_cost"]), float(ma["optimum_cost"]),
                                   rtol=COST_RTOL)
