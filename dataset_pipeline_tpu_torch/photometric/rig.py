"""Camera-rig assignment and extrinsics initialisation.

Port of ``dataset_pipeline_tpu/photometric/rig.py``:

- ``rigs.json`` lists, per rig, an ordered camera set (the first is the
  reference) with an image folder prefix each; images are grouped into
  synchronised ``RigSet``s by file name;
- the initial extrinsics ``image_T_rig[c]`` are the inverse of the average of
  ``reference_T_other`` over the sets where both images are registered (the
  rotation averaged by projecting the summed matrices onto SO(3) by SVD);
- each set's rig pose is the average of ``global_T_image . image_T_rig[c]``
  over its registered images; every image gets the consistent pose back, and
  images missing from a set are added at their rig-predicted pose.

Host float64 math, as in the JAX package; the quaternion conversions go
through the port's float32 ``models/lie.py`` as the JAX code's go through
its own.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from dataset_pipeline_tpu_torch import default_device
from dataset_pipeline_tpu_torch.io.colmap import ColmapRig, read_rigs_json
from dataset_pipeline_tpu_torch.io.state import ImageState, ModelState
from dataset_pipeline_tpu_torch.models.lie import SE3, quat_from_matrix, quat_to_matrix


def _rot(q):
    return quat_to_matrix(torch.as_tensor(np.asarray(q, np.float32))).numpy().astype(np.float64)


def _project_rotation(Rsum: np.ndarray) -> np.ndarray:
    u, _, vt = np.linalg.svd(Rsum)
    R = u @ vt
    if np.linalg.det(R) < 0:
        u[:, -1] *= -1
        R = u @ vt
    return R


@dataclass
class RigSet:
    filename: str
    image_ids: List[int]  # per camera index; -1 = was missing (image added)


@dataclass
class RigInfo:
    rig_id: int
    folder_names: List[str]
    camera_ids: List[int] = field(default_factory=list)  # COLMAP camera id per rig camera
    image_T_rig: List[np.ndarray] = field(default_factory=list)  # (4,4) per camera
    sets: List[RigSet] = field(default_factory=list)


def assign_rigs(state: ModelState, rig_configs: List[ColmapRig]) -> List[RigInfo]:
    """Make ``state.images``' poses rig-consistent (and append the missing
    images); returns the rig structures."""
    prefix_to_rig: Dict[str, Tuple[int, int]] = {}
    rigs: List[RigInfo] = []
    for cfg in rig_configs:
        if len(cfg.cameras) <= 1:
            continue
        rig = RigInfo(len(rigs), [c.image_prefix for c in cfg.cameras])
        for ci, cam in enumerate(cfg.cameras):
            prefix_to_rig[cam.image_prefix] = (rig.rig_id, ci)
        rigs.append(rig)
    if not rigs:
        return []

    by_id = {im.image_id: im for im in state.images}
    sets_by_key: Dict[Tuple[int, str], RigSet] = {}
    cam_folder: Dict[Tuple[int, int], str] = {}
    cam_colmap_id: Dict[Tuple[int, int], int] = {}
    for im in state.images:
        hit = prefix_to_rig.get(os.path.basename(os.path.dirname(im.name)))
        if hit is None:
            continue
        rig_id, ci = hit
        filename = os.path.basename(im.name)
        key = (rig_id, filename)
        if key not in sets_by_key:
            s = RigSet(filename, [-1] * len(rigs[rig_id].folder_names))
            sets_by_key[key] = s
            rigs[rig_id].sets.append(s)
        sets_by_key[key].image_ids[ci] = im.image_id
        cam_folder[(rig_id, ci)] = os.path.dirname(im.name)
        cam_colmap_id[(rig_id, ci)] = im.camera_id

    next_id = max(by_id) + 1 if by_id else 1
    for rig in rigs:
        n = len(rig.folder_names)
        rig.camera_ids = [cam_colmap_id.get((rig.rig_id, c), -1) for c in range(n)]
        # average relative poses reference_T_other
        Rsum = [np.zeros((3, 3)) for _ in range(n - 1)]
        tsum = [np.zeros(3) for _ in range(n - 1)]
        cnt = [0] * (n - 1)
        for s in rig.sets:
            if s.image_ids[0] < 0:
                continue
            ref = by_id[s.image_ids[0]]
            R_ref = _rot(ref.qvec)
            for c in range(1, n):
                if s.image_ids[c] < 0:
                    continue
                other = by_id[s.image_ids[c]]
                R_o = _rot(other.qvec)
                # reference_T_other = image_T_global(ref) . global_T_image(other)
                Rsum[c - 1] += R_ref @ R_o.T
                tsum[c - 1] += R_ref @ (-R_o.T @ other.tvec) + ref.tvec
                cnt[c - 1] += 1
        rig.image_T_rig = [np.eye(4)]
        for c in range(1, n):
            if cnt[c - 1] == 0:
                rig.image_T_rig.append(np.eye(4))
                continue
            ref_T_other = np.eye(4)
            ref_T_other[:3, :3] = _project_rotation(Rsum[c - 1])
            ref_T_other[:3, 3] = tsum[c - 1] / cnt[c - 1]
            rig.image_T_rig.append(np.linalg.inv(ref_T_other))

        # per set: average rig pose, back-assign, add missing images
        for s in rig.sets:
            Gsum = np.zeros((3, 3))
            gtsum = np.zeros(3)
            m = 0
            for c in range(n):
                if s.image_ids[c] < 0:
                    continue
                im = by_id[s.image_ids[c]]
                R_i = _rot(im.qvec)
                g_T_i = np.eye(4)
                g_T_i[:3, :3] = R_i.T
                g_T_i[:3, 3] = -R_i.T @ im.tvec
                g_T_rig = g_T_i @ rig.image_T_rig[c]
                Gsum += g_T_rig[:3, :3]
                gtsum += g_T_rig[:3, 3]
                m += 1
            if m == 0:
                continue
            g_T_rig = np.eye(4)
            g_T_rig[:3, :3] = _project_rotation(Gsum)
            g_T_rig[:3, 3] = gtsum / m
            for c in range(n):
                i_T_g = np.linalg.inv(g_T_rig @ np.linalg.inv(rig.image_T_rig[c]))
                q = quat_from_matrix(torch.as_tensor(i_T_g[:3, :3].astype(np.float32))
                                     ).numpy().astype(np.float64)
                t = i_T_g[:3, 3]
                iid = s.image_ids[c]
                if iid < 0:
                    folder = cam_folder.get((rig.rig_id, c))
                    camid = cam_colmap_id.get((rig.rig_id, c), -1)
                    if folder is None or camid < 0:
                        continue
                    new_im = ImageState(next_id, camid, os.path.join(folder, s.filename), q, t)
                    state.images.append(new_im)
                    by_id[next_id] = new_im
                    s.image_ids[c] = next_id
                    next_id += 1
                else:
                    by_id[iid].qvec = q
                    by_id[iid].tvec = t
    return rigs


def rig_extrinsics_se3(rig: RigInfo, device=None) -> SE3:
    """Stacked SE3 (ncams,) of image_T_rig on ``device``."""
    mats = np.stack(rig.image_T_rig).astype(np.float32)
    return SE3.from_matrix(torch.as_tensor(mats, device=default_device(device)))


def mark_rig_groups(state, groups, rig_infos, device=None):
    """Derive the extrinsics and mark the dependent image groups (rig_id,
    rig_cam_index, ref_group, ref_slots) on the loaded groups. Returns the
    rig extrinsics list."""
    rig_extrinsics = []
    cam_to_group = {}
    for gi, g in enumerate(groups):
        for im in state.images:
            if im.image_id in g.image_ids:
                cam_to_group[im.camera_id] = gi
                break
    for rig in rig_infos:
        rig_extrinsics.append(rig_extrinsics_se3(rig, device))
        ref_gi = cam_to_group.get(rig.camera_ids[0], -1)
        if ref_gi < 0:
            continue
        ref_ids = groups[ref_gi].image_ids
        set_of_image = {}
        for s_ in rig.sets:
            for iid in s_.image_ids:
                set_of_image[iid] = s_
        for c in range(1, len(rig.camera_ids)):
            gi = cam_to_group.get(rig.camera_ids[c], -1)
            if gi < 0:
                continue
            g = groups[gi]
            slots = []
            for iid in g.image_ids:
                s_ = set_of_image.get(iid)
                if s_ is None or s_.image_ids[0] not in ref_ids:
                    break
                slots.append(ref_ids.index(s_.image_ids[0]))
            else:
                g.rig_id = rig.rig_id
                g.rig_cam_index = c
                g.ref_group = ref_gi
                g.ref_slots = np.asarray(slots, np.int32)
    return rig_extrinsics


def assign_rigs_from_state_dir(state: ModelState, state_dir: str) -> List[RigInfo]:
    """Read ``rigs.json`` beside a COLMAP state (if present) and assign the
    rigs: :func:`assign_rigs`, which makes the state's poses rig-consistent,
    so it runs before the image groups copy them. [] without ``rigs.json``."""
    rigs_path = os.path.join(state_dir, "rigs.json")
    if not os.path.exists(rigs_path):
        return []
    return assign_rigs(state, read_rigs_json(rigs_path))
