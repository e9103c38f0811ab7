"""The hand-written kernel ``csrc/hb_geometry.cu`` for the geometry of the
registrator's H,b accumulation (``photometric/optimizer.py:_hb_batch``).

Before the pyramid sample (kernel B3), :func:`project` gives each (image,
point) row's pixel and validity; after it, :func:`jacobian` gives the row of
the intensity Jacobian ``J (nb, M, V)``: per variable, [P intrinsics | 6
pose] or the pose alone, the forward tangent of the pixel and, with
``dynamic_scale``, of the footprint scale, chained with B3's derivatives.
Points are ``(M, 3)``, shared by the chunk's images, or ``(nb, M, 3)``, the
observations cache's views.

``_hb_batch`` launches the kernel where :func:`uses_kernel` holds (points on
the card, a camera model in :data:`KERNEL_MODELS`: PINHOLE, SIMPLE_PINHOLE and
THIN_PRISM_FISHEYE, V up to 18) and takes its plain
version, ``torch.func.jvp`` under ``vmap`` (``optimizer._project_plain``,
``optimizer._jacobian_plain``, the oracle), everywhere else.
``kernels.LAUNCHES`` counts the launches per mode (``hb_geometry_project``,
``hb_geometry_jacobian``).
"""

from __future__ import annotations

import torch

from dataset_pipeline_tpu_torch import kernels
from dataset_pipeline_tpu_torch.models import cameras as cm

# the kernel's ``model`` argument per camera model it implements
_MODEL_IDS = {"PINHOLE": 0, "SIMPLE_PINHOLE": 1, "THIN_PRISM_FISHEYE": 2}
KERNEL_MODELS = tuple(_MODEL_IDS)


def uses_kernel(camera: cm.Camera, points) -> bool:
    """Whether the kernel computes the geometry of these inputs: points on
    the card and a model the kernel implements."""
    return points.device.type == "cuda" and camera.spec.name in KERNEL_MODELS


def _cutoff(camera: cm.Camera, device):
    """The camera's ``radius_cutoff_sq`` as (device pointer or None, value):
    a tensor on the card is read there, so that nothing waits for it."""
    x = camera.radius_cutoff_sq
    if x.numel() != 1 or x.dtype != torch.float32:
        raise ValueError(f"radius_cutoff_sq: expected one float32; got {x.dtype} {tuple(x.shape)}")
    if x.device.type != "cuda":
        return None, float(x)
    if x.device != device:
        raise ValueError(f"radius_cutoff_sq on {x.device}, inputs on {device}")
    return x.data_ptr(), 0.0


def _kernel_args(camera: cm.Camera, params, pose_q, pose_t, points):
    """The checked kernel inputs: contiguous (pose_q, pose_t, params,
    points), nb, M and whether the points are per image."""
    if not uses_kernel(camera, points):
        raise ValueError(f"the kernel takes points on the card and a camera of {KERNEL_MODELS}; "
                         f"got {camera.spec.name} on {points.device}")
    nb = pose_q.shape[0]
    per_image = points.dim() == 3
    M = points.shape[-2]
    if (tuple(pose_q.shape) != (nb, 4) or tuple(pose_t.shape) != (nb, 3)
            or tuple(points.shape) != ((nb, M, 3) if per_image else (M, 3))
            or tuple(params.shape) != (camera.spec.param_count,)):
        raise ValueError(f"poses (nb,4)/(nb,3), points (M,3) or (nb,M,3), params "
                         f"({camera.spec.param_count},); got {tuple(pose_q.shape)}, "
                         f"{tuple(pose_t.shape)}, {tuple(points.shape)}, {tuple(params.shape)}")
    args = [x.contiguous() for x in (pose_q, pose_t, params, points)]
    for x in args:
        if x.dtype != torch.float32 or x.device != points.device:
            raise ValueError(f"inputs must be float32 on {points.device}; got {x.dtype} on "
                             f"{x.device}")
    return args, nb, M, per_image


def project(camera: cm.Camera, params, pose_q, pose_t, points):
    """(pix (nb,M,2) float32, valid (nb,M) bool) of the chunk's rows by the
    kernel's ``project`` mode: pix under ``SE3.exp(0).compose(pose)``, the
    pose at which :func:`jacobian` differentiates, valid under the pose
    itself."""
    args, nb, M, per_image = _kernel_args(camera, params, pose_q, pose_t, points)
    q, t, prm, pts = (x.data_ptr() for x in args)
    cut_ptr, cut = _cutoff(camera, points.device)
    pix = torch.empty((nb, M, 2), dtype=torch.float32, device=points.device)
    valid = torch.empty((nb, M), dtype=torch.bool, device=points.device)
    err = kernels.library().dpt_hb_geometry_project(
        q, t, prm, _MODEL_IDS[camera.spec.name], cut_ptr, cut, pts, int(per_image), M, nb,
        pix.data_ptr(), valid.data_ptr(), torch.cuda.current_stream(points.device).cuda_stream)
    kernels.check(err, "dpt_hb_geometry_project")
    if M:  # the entry point launches nothing for zero rows
        kernels.LAUNCHES["hb_geometry_project"] += 1
    return pix, valid


def jacobian(camera: cm.Camera, params, pose_q, pose_t, points, radius: float, dpx, dpy, dvds,
             optimize_intrinsics: bool, dynamic_scale: bool):
    """J (nb,M,V) float32 of the chunk's rows by the kernel's ``jacobian``
    mode, V = P + 6 or 6 without intrinsics, from B3's derivatives ``dpx,
    dpy, dvds`` (nb,M) and the level's point radius. Rows that
    :func:`project` marks invalid may hold any value."""
    args, nb, M, per_image = _kernel_args(camera, params, pose_q, pose_t, points)
    q, t, prm, pts = (x.data_ptr() for x in args)
    derivs = [x.contiguous() for x in (dpx, dpy, dvds)]
    for x in derivs:
        if tuple(x.shape) != (nb, M) or x.dtype != torch.float32 or x.device != points.device:
            raise ValueError(f"dpx, dpy, dvds must be ({nb}, {M}) float32 on {points.device}; "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    V = (params.shape[0] if optimize_intrinsics else 0) + 6
    J = torch.empty((nb, M, V), dtype=torch.float32, device=points.device)
    err = kernels.library().dpt_hb_geometry_jacobian(
        q, t, prm, _MODEL_IDS[camera.spec.name], pts, int(per_image), M, nb,
        *(x.data_ptr() for x in derivs), float(radius), int(dynamic_scale),
        int(optimize_intrinsics), J.data_ptr(), torch.cuda.current_stream(points.device).cuda_stream)
    kernels.check(err, "dpt_hb_geometry_jacobian")
    if M:
        kernels.LAUNCHES["hb_geometry_jacobian"] += 1
    return J
