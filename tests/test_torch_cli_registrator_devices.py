"""Port vs JAX: the ImageRegistrator CLI at ``--devices 2`` on the CPU.

A three-image 320x240 scene (``utils/synthetic.write_scene``; two image
scales, so one scale run) through the JAX tool at ``--devices 2`` (its 8-virtual-device CPU
platform) and through the port at ``--devices 2 --device cpu``, which starts
two Gloo ranks itself: each chunk of three images is split two and one over
the ranks. Rank 0 alone writes the files. The same again on a three-image
480x320 scene (three image scales, so two scale runs) with
``--cache_observations`` and ``--variable_residuals_weight 0.5``: the second
scale runs on the observations cache, whose per-image views and the
variable descriptors gathered into them are split with the images.
Tolerances, those of the one-device parity test
(``test_torch_image_registrator.py``): qvec and tvec 5e-7 per entry,
intrinsics 1e-3 px, optimum cost 1e-4 relative; and the port's two ranks
end where its single rank does, to the bit.
"""

import json
import os

import numpy as np
import pytest
import torch

from dataset_pipeline_tpu.io import colmap as jcio
from dataset_pipeline_tpu_torch.tools import image_registrator as treg
from dataset_pipeline_tpu_torch.utils.synthetic import write_scene

torch.set_num_threads(2)
Q_TOL, T_TOL, PARAM_TOL, COST_RTOL = 5e-7, 5e-7, 1e-3, 1e-4
W, H = 320, 240


CACHE_FLAGS = ["--cache_observations", "--variable_residuals_weight", "0.5",
               "--max_iterations", "2"]


def _args(root, out, extra=()):
    return ["--scan_alignment_path", str(root / "scene.mlp"),
            "--image_base_path", str(root / "images"), "--state_path", str(root / "state"),
            "--output_folder_path", str(root / out), "--max_iterations", "3", *extra]


def _states(root, out):
    return {d: jcio.read_model(str(root / out / d)) for d in sorted(os.listdir(root / out))
            if d.startswith("scale_")}


def _optimum(root, out, d):
    return float(dict(line.split(" ", 1) for line in open(root / out / d / "metadata.txt")
                      .read().splitlines())["optimum_cost"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from dataset_pipeline_tpu.tools.image_registrator import main as jax_main

    root = tmp_path_factory.mktemp("registrator_devices")
    write_scene(str(root), W, H, 2800.0 * W / 3072, 3, 10_000, seed=3, device="cpu")
    assert jax_main(_args(root, "jax", ["--devices", "2"])) == 0
    stats = {}
    assert treg.main(_args(root, "port2", ["--device", "cpu", "--devices", "2"]), stats=stats) == 0
    assert treg.main(_args(root, "port1", ["--device", "cpu"])) == 0
    return root, stats


@pytest.fixture(scope="module")
def cache_runs(tmp_path_factory):
    from dataset_pipeline_tpu.tools.image_registrator import main as jax_main

    root = tmp_path_factory.mktemp("registrator_devices_cache")
    write_scene(str(root), 480, 320, 2800.0 * 480 / 3072, 3, 6000, seed=7, device="cpu")
    assert jax_main(_args(root, "jax", ["--devices", "2", *CACHE_FLAGS])) == 0
    stats = {}
    assert treg.main(_args(root, "port2", ["--device", "cpu", "--devices", "2", *CACHE_FLAGS]),
                     stats=stats) == 0
    assert treg.main(_args(root, "port1", ["--device", "cpu", *CACHE_FLAGS])) == 0
    return root, stats


def _match_jax(root, stats, scales):
    want, got = _states(root, "jax"), _states(root, "port2")
    assert list(got) == list(want) == scales
    for d in want:
        a, b = want[d], got[d]
        for i in a.images:
            np.testing.assert_allclose(b.images[i].qvec, a.images[i].qvec, rtol=0, atol=Q_TOL)
            np.testing.assert_allclose(b.images[i].tvec, a.images[i].tvec, rtol=0, atol=T_TOL)
        for c in a.cameras:
            np.testing.assert_allclose(b.cameras[c].params, a.cameras[c].params, rtol=0,
                                       atol=PARAM_TOL)
        np.testing.assert_allclose(_optimum(root, "port2", d), _optimum(root, "jax", d),
                                   rtol=COST_RTOL)
    assert sorted(os.listdir(root / "port2")) == sorted(os.listdir(root / "jax"))
    ranks = stats["ranks"]
    assert [r["collectives"]["backend"] for r in ranks] == ["gloo", "gloo"]
    assert all(r["collectives"]["calls"] > 0 for r in ranks)


def _match_one_rank(root, scales):
    one, two = _states(root, "port1"), _states(root, "port2")
    assert list(one) == list(two) == scales
    for d in one:
        for i in one[d].images:
            np.testing.assert_array_equal(two[d].images[i].qvec, one[d].images[i].qvec)
            np.testing.assert_array_equal(two[d].images[i].tvec, one[d].images[i].tvec)


def test_two_ranks_match_the_jax_tool_at_two_devices(runs):
    _match_jax(*runs, ["scale_1_state"])


def test_two_ranks_end_where_one_rank_does(runs):
    """Sharding the H,b accumulation over the image axis changes no
    per-image block and only the order of the cost sums."""
    _match_one_rank(runs[0], ["scale_1_state"])


def test_two_ranks_on_the_observations_cache_match_the_jax_tool(cache_runs):
    root, stats = cache_runs
    _match_jax(root, stats, ["scale_0.5_state", "scale_1_state"])
    assert "observations_cache" in json.load(open(root / "port2" / "timing.json"))


def test_two_ranks_on_the_observations_cache_end_where_one_rank_does(cache_runs):
    """The cache's per-image views and descriptors are split with the
    images: every per-image block is the one rank's."""
    _match_one_rank(cache_runs[0], ["scale_0.5_state", "scale_1_state"])
