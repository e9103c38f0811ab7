"""The port's multi-device dry run (``entry.dryrun_multichip``) and the rank
launcher's failure path (``parallel/mesh.py:launch``), on Gloo CPU ranks.

``dryrun_multichip(4)`` runs the six stages of the JAX package's
``__graft_entry__.dryrun_multichip`` on four ranks (the 2 x 2 mesh stage
included), each rank asserting finite outputs; every rank must end with the
same values, since each solves the same replicated system.
"""

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from dataset_pipeline_tpu_torch.entry import dryrun_multichip
from dataset_pipeline_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)
STAGES = ("icp_cost", "moment_cost", "joint_ba_cost", "rig_joint_ba_cost", "host_device_cost",
          "photometric_cost")


def test_dryrun_multichip_on_four_cpu_ranks():
    out = dryrun_multichip(4, device="cpu")
    assert [r["rank"] for r in out] == [0, 1, 2, 3]
    for r in out:
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert all(np.isfinite(r[k]) for k in STAGES), r
        assert r["collective_calls"] > 0
        assert {k: r[k] for k in STAGES} == {k: out[0][k] for k in STAGES}


def test_a_failing_rank_stops_the_launch():
    """Rank 1 raises while rank 0 waits in a collective: the launch ends and
    raises with rank 1's traceback instead of hanging."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*ValueError: planted"):
        tmesh.launch(ranks.failing, 2, ("planted",))
