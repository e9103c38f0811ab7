"""The geometry of the registrator's H,b accumulation: the plain version
and the hand-written kernel ``csrc/hb_geometry.cu``.

Before the pyramid sample (kernel B3), :func:`project` gives each (image,
point) row's pixel and validity; after it, :func:`jacobian` gives the row of
the intensity Jacobian ``J (nb, M, V)``: per variable, [P intrinsics | 6
pose] or the pose alone, the forward tangent of the pixel and, with
``dynamic_scale``, of the footprint scale, chained with B3's derivatives.
Points are ``(M, 3)``, shared by the chunk's images, or ``(nb, M, 3)``, the
observations cache's views.

Both launch the kernel where :func:`uses_kernel` holds (points on the card, a
camera model in :data:`KERNEL_MODELS`: PINHOLE, SIMPLE_PINHOLE and
THIN_PRISM_FISHEYE, V up to 18) and take the plain version everywhere else:
:func:`project_plain` and :func:`jacobian_plain`, ``torch.func.jvp`` under
``vmap``, which are also the kernel's oracle. The forward-mode machinery
(:func:`forward_jacobian`, :func:`geom_fn`, :func:`intensity_chain`,
:func:`tangent_basis`) serves the rig and depth rows and joint BA too, and
:func:`footprint_scale` is the one formula of the observation scale, which
the visibility pass and the Jacobian share.
``kernels.LAUNCHES`` counts the launches per mode (``hb_geometry_project``,
``hb_geometry_jacobian``).
"""

from __future__ import annotations

import torch

from dataset_pipeline_tpu_torch import kernels
from dataset_pipeline_tpu_torch.models import cameras as cm
from dataset_pipeline_tpu_torch.models.lie import SE3

_JVP_ELEMENTS = 1 << 25  # (tangent, image, point) triples per vmapped jvp pass

# the kernel's ``model`` argument per camera model it implements
_MODEL_IDS = {"PINHOLE": 0, "SIMPLE_PINHOLE": 1, "THIN_PRISM_FISHEYE": 2}
KERNEL_MODELS = tuple(_MODEL_IDS)


def uses_kernel(camera: cm.Camera, points) -> bool:
    """Whether the kernel computes the geometry of these inputs: points on
    the card and a model the kernel implements."""
    return points.device.type == "cuda" and camera.spec.name in KERNEL_MODELS


def batch_pose(q, t) -> SE3:
    """(nb,) poses shaped to broadcast against (M,3) points: (nb,1,·)."""
    return SE3(q[:, None, :], t[:, None, :])


def project_full(camera: cm.Camera, params, p_cam):
    """Project with explicit params at scale 0: (pix, valid)."""
    return cm.project(camera.with_params(params), p_cam)


def footprint_scale(camera: cm.Camera, p_cam, pix, radius):
    """Continuous observation scale log2(2 radius_px) of camera-frame points
    ``p_cam`` projecting to ``pix`` under ``camera``: the pixels per metre
    from a second projection 1e-3 z along x."""
    z = p_cam[..., 2]
    eps = 1e-3 * torch.clamp(z, min=1e-6)
    p2 = p_cam + torch.stack([eps, torch.zeros_like(eps), torch.zeros_like(eps)], -1)
    pix2, _ = cm.project(camera, p2)
    px_per_m = torch.sqrt(cm._sqnorm(pix2 - pix, keepdim=False)) / eps
    return torch.log2(torch.clamp(2.0 * (radius * px_per_m), min=1e-12))


def tangent_basis(P: int, n_pose: int, optimize_intrinsics: bool, device):
    """Tangent basis over [P intrinsics | n_pose pose dofs]; without
    intrinsics only the pose rows."""
    out = torch.eye(P + n_pose, dtype=torch.float32, device=device)
    return out if optimize_intrinsics else out[P:]


def forward_jacobian(geom, primals, tangents_of, basis, combine, elements: int):
    """J (..., V): one column per row of ``basis``, ``combine`` applied to
    ``geom``'s output tangents along ``tangents_of(basis row)`` (what jacfwd
    computes), vmapped in chunks so that no intermediate holds more than
    ~_JVP_ELEMENTS points."""

    def column(t):
        _, dout = torch.func.jvp(geom, primals, tangents_of(t))
        return combine(dout)

    chunk = max(1, _JVP_ELEMENTS // max(elements, 1))
    return torch.func.vmap(column, out_dims=-1, chunk_size=chunk)(basis)


def intensity_chain(dpx, dpy, dvds, dynamic_scale: bool):
    """dI/dvar from (dpix/dvar, dfootprint/dvar)."""

    def combine(dout):
        dpix, dfp = dout
        col = dpx * dpix[..., 0] + dpy * dpix[..., 1]
        return col + dvds * dfp if dynamic_scale else col

    return combine


def geom_fn(camera, points, radius, dynamic_scale: bool, pose_of):
    """(pix, footprint scale) of ``points`` under ``pose_of(*eps)`` and the
    intrinsics ``prm`` (the last argument): the gather-free part of the
    Jacobian chain."""

    def geom(*args):
        pose = pose_of(*args[:-1])
        c = camera.with_params(args[-1])
        p_cam = pose.apply(points)
        pix, _ = cm.project(c, p_cam)
        if dynamic_scale:
            fp = footprint_scale(c, p_cam, pix, radius)
        else:
            fp = torch.zeros(pix.shape[:-1], dtype=pix.dtype, device=pix.device)
        return pix, fp

    return geom


def project_plain(camera, params, pose_q, pose_t, points):
    """:func:`project` off the card or for the models the kernel does not
    implement, and the kernel's oracle: pix under
    ``SE3.exp(0).compose(pose)``, the pose at which :func:`jacobian_plain`
    differentiates, valid under the pose itself."""
    pose0 = batch_pose(pose_q, pose_t)
    eps0 = torch.zeros(6, dtype=torch.float32, device=points.device)
    pix, _ = project_full(camera, params, SE3.exp(eps0).compose(pose0).apply(points))
    _, valid = project_full(camera, params, pose0.apply(points))
    return pix, valid


def jacobian_plain(camera, params, pose_q, pose_t, points, radius, dpx, dpy, dvds,
                   optimize_intrinsics: bool, dynamic_scale: bool):
    """J (nb,M,V) of :func:`project_plain`'s rows by ``torch.func.jvp``
    under ``vmap``: each image's pixel depends only on its own pose, so one
    shared 6-vector tangent gives every image's pose Jacobian at once. In
    the points' dtype (float64 inputs give the kernel's float64 oracle)."""
    pose0 = batch_pose(pose_q, pose_t)
    geom = geom_fn(camera, points, radius, dynamic_scale,
                   lambda eps: SE3.exp(eps).compose(pose0))
    eps0 = torch.zeros(6, dtype=points.dtype, device=points.device)
    P = params.shape[0]
    return forward_jacobian(geom, (eps0, params), lambda t: (t[P:], t[:P]),
                            tangent_basis(P, 6, optimize_intrinsics, eps0.device).to(eps0.dtype),
                            intensity_chain(dpx, dpy, dvds, dynamic_scale),
                            dpx.shape[0] * dpx.shape[1])


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
    """(pix (nb,M,2) float32, valid (nb,M) bool) of the chunk's rows: pix
    under ``SE3.exp(0).compose(pose)``, the pose at which :func:`jacobian`
    differentiates, valid under the pose itself. By the kernel's ``project``
    mode where :func:`uses_kernel` holds, else by :func:`project_plain`."""
    if not uses_kernel(camera, points):
        return project_plain(camera, params, pose_q, pose_t, points)
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
    """J (nb,M,V) of the chunk's rows, V = P + 6 or 6 without intrinsics,
    from B3's derivatives ``dpx, dpy, dvds`` (nb,M) and the level's point
    radius: by the kernel's ``jacobian`` mode (float32) where
    :func:`uses_kernel` holds, else by :func:`jacobian_plain`. Rows that
    :func:`project` marks invalid may hold any value."""
    if not uses_kernel(camera, points):
        return jacobian_plain(camera, params, pose_q, pose_t, points, radius, dpx, dpy, dvds,
                              optimize_intrinsics, dynamic_scale)
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
