"""Triangle-mesh depth rasterization with occlusion-boundary edge splatting.

Port of ``dataset_pipeline_tpu/ops/mesh_raster.py``:

- vertices are projected through the full camera model (the mesh must be
  finely subdivided, as for the reference's vertex-distorting GL renderer);
- a triangle rasterizes its screen bounding box, up to ``tile`` x ``tile``
  pixels (tiers 8 and 32; larger triangles are dropped), with barycentric
  inside tests and perspective-correct 1/z interpolation, into a min
  z-buffer; the background is 0;
- silhouette edges stamp squares of ``splat_radius`` along their length,
  setting nearby background / behind pixels to -1 (occluded).

The JAX tiers are a loop of ``tile^2`` scatter passes over every face. Here
a tier is one pass over (faces that fit the tier and have area) x (the
``tile^2`` pixels of their box), in chunks of faces; a face that does not fit
adds nothing in JAX either, so the 32-pixel tier sees only the faces the
8-pixel tier left. The depth is a ``scatter_reduce_`` ``amin``, the edge marks
an OR, neither depends on the order of writes. The colour pass keeps the JAX
CPU scatter's last writer in (tier, pixel offset, face) order: the winning
write of a pixel is the one with the largest such key (``amax``), then
gathered, so the card gives the same colours.

The barycentrics and depths are written as the fused multiply-adds XLA's CPU
backend makes of them (``a*b - c*d`` as ``fma(a, b, -(c*d))``, a sum of
products as an FMA chain), so that the inside tests and depths match the JAX
function bit for bit on the CPU, and the card computes the same ops.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dataset_pipeline_tpu_torch import default_device
from dataset_pipeline_tpu_torch.models import cameras as cm
from dataset_pipeline_tpu_torch.models.lie import SE3, dot3_fused, fms, quat_conjugate, quat_rotate_fused

TILES = (8, 32)
_CHUNK = 1 << 22  # (face, pixel) pairs per pass; bounds the temporaries only


class OcclusionMesh(NamedTuple):
    vertices: torch.Tensor  # (V,3) float32
    faces: torch.Tensor  # (F,3) int64
    face_normals: torch.Tensor  # (F,3) float32, normalized winding normals
    edges: torch.Tensor  # (E,2) int64 vertex indices
    edge_faces: torch.Tensor  # (E,2) int64, second = -1 for boundary edges
    edge_opposite: torch.Tensor  # (E,) bool: the two faces have opposite winding


def build_occlusion_mesh(vertices: np.ndarray, faces: np.ndarray, device=None) -> OcclusionMesh:
    """Host-side edge / face-normal precomputation (a numpy copy of the JAX
    function); the tensors go to ``device`` (the card when none is named)."""
    vertices = np.array(vertices, np.float32)
    faces = np.array(faces, np.int64)
    v = vertices[faces]  # (F,3,3)
    fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    norm = np.linalg.norm(fn, axis=1, keepdims=True)
    fn = fn / np.maximum(norm, 1e-30)

    # half edges: (min_v, max_v, face, swapped)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    face_of = np.tile(np.arange(len(faces)), 3)
    swapped = e[:, 0] > e[:, 1]
    e_sorted = np.sort(e, axis=1)
    key = e_sorted[:, 0] * (vertices.shape[0] + 1) + e_sorted[:, 1]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, starts, counts = np.unique(key_s, return_index=True, return_counts=True)

    E = len(uniq)
    edges = np.zeros((E, 2), np.int32)
    edge_faces = np.full((E, 2), -1, np.int32)
    edge_opp = np.zeros(E, bool)
    keep = np.ones(E, bool)

    e_sorted_s = e_sorted[order]
    face_s = face_of[order]
    swap_s = swapped[order]

    # vectorized fill for the manifold cases (1 or 2 faces)
    edges[:, 0] = e_sorted_s[starts, 0]
    edges[:, 1] = e_sorted_s[starts, 1]
    edge_faces[:, 0] = face_s[starts]
    two = counts >= 2
    edge_faces[two, 1] = face_s[starts[two] + 1]
    f1_sign = np.where(swap_s[starts], -1.0, 1.0)
    f2_sign = np.where(two, np.where(swap_s[np.minimum(starts + 1, len(face_s) - 1)], -1.0, 1.0), 1.0)
    edge_opp[two] = (f1_sign[two] * f2_sign[two]) > 0

    # coplanar opposite-normal pairs are dropped (surface is a plane there)
    if two.any():
        i2 = np.nonzero(two)[0]
        n1 = fn[edge_faces[i2, 0]] * f1_sign[i2, None]
        n2 = fn[edge_faces[i2, 1]] * f2_sign[i2, None]
        dots = (n1 * n2).sum(1)
        planar = dots < -1.0 + 1e-6
        keep[i2[planar]] = False

    # non-manifold edges (>2 faces): keep the 2 outermost faces in the
    # hemisphere spanned around the edge; drop if not in one hemisphere
    nm = np.nonzero(counts > 2)[0]
    for idx in nm:
        s0 = starts[idx]
        c = counts[idx]
        f_ids = face_s[s0:s0 + c]
        signs = np.where(swap_s[s0:s0 + c], -1.0, 1.0)
        normals = fn[f_ids] * signs[:, None]
        v1, v2 = edges[idx]
        edge_vec = vertices[v2] - vertices[v1]
        base_x = normals[0] / max(np.linalg.norm(normals[0]), 1e-30)
        base_y = np.cross(base_x, edge_vec)
        base_y /= max(np.linalg.norm(base_y), 1e-30)
        pts2 = np.stack([normals @ base_x, normals @ base_y], -1)
        a_i, b_i = 0, 1
        a, b = pts2[0], pts2[1]
        ok = True
        for j in range(2, c):
            n3 = pts2[j]
            cab = a[0] * b[1] - a[1] * b[0]
            ca3 = a[0] * n3[1] - a[1] * n3[0]
            cb3 = b[0] * n3[1] - b[1] * n3[0]
            same_a = (ca3 >= 0) == (cab >= 0)
            same_b = (cb3 >= 0) == (-cab >= 0)
            if same_a and same_b:
                continue  # n3 between a and b
            elif same_a:
                b, b_i = n3, j
            elif same_b:
                a, a_i = n3, j
            else:
                ok = False
                break
        if not ok:
            keep[idx] = False
            continue
        edge_faces[idx, 0] = f_ids[a_i]
        edge_faces[idx, 1] = f_ids[b_i]
        edge_opp[idx] = signs[a_i] * signs[b_i] > 0

    edges, edge_faces, edge_opp = edges[keep], edge_faces[keep], edge_opp[keep]
    dev = default_device(device)
    return OcclusionMesh(
        torch.from_numpy(vertices).to(dev), torch.from_numpy(faces).to(dev),
        torch.from_numpy(fn.astype(np.float32)).to(dev),
        torch.from_numpy(edges.astype(np.int64)).to(dev),
        torch.from_numpy(edge_faces.astype(np.int64)).to(dev),
        torch.from_numpy(edge_opp).to(dev),
    )


def _tier_fits(pix, remaining, faces, tile: int):
    """Faces of ``remaining`` whose screen box fits ``tile`` pixels, and the
    (F,3,2) vertex pixels and box corner."""
    p = pix[faces]  # (F,3,2)
    lo = torch.floor(torch.amin(p, 1))
    extent = torch.ceil(torch.amax(p, 1)) - lo + 1.0
    fits = remaining & (extent[:, 0] <= tile) & (extent[:, 1] <= tile)
    return fits, p, lo


def _tier_pixels(pix, z, fits, faces, lo, p, tile: int, width: int, height: int):
    """Yield, per chunk of the faces that fit and have area, the covered
    pixels: (face ids (S,), offset ids (K,), flat (S,K), ok (S,K), the
    barycentrics w (3,S,K), the vertices' 1/z (S,3), the pixel depth (S,K))."""
    a, b, c = p[:, 0], p[:, 1], p[:, 2]
    area = fms(b[:, 0] - a[:, 0], c[:, 1] - a[:, 1], b[:, 1] - a[:, 1], c[:, 0] - a[:, 0])
    sel = torch.nonzero(fits & (torch.abs(area) > 1e-12))[:, 0]
    K = tile * tile
    k = torch.arange(K, device=pix.device)
    dy, dx = k // tile, k % tile
    step = max(1, _CHUNK // K)
    for s in range(0, sel.shape[0], step):
        f = sel[s:s + step]
        a_, b_, c_ = a[f, None, :], b[f, None, :], c[f, None, :]
        inv_area = 1.0 / area[f, None]
        inv_z = 1.0 / torch.clamp(z[faces[f]], min=1e-12)  # (S,3)
        lo_i = lo[f].long()
        px = lo_i[:, 0:1] + dx
        py = lo_i[:, 1:2] + dy
        fx, fy = px.to(torch.float32), py.to(torch.float32)
        w0 = fms(b_[..., 0] - fx, c_[..., 1] - fy, b_[..., 1] - fy, c_[..., 0] - fx) * inv_area
        w1 = fms(c_[..., 0] - fx, a_[..., 1] - fy, c_[..., 1] - fy, a_[..., 0] - fx) * inv_area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        iz = torch.addcmul(torch.addcmul(w1 * inv_z[:, 1:2], w0, inv_z[:, 0:1]), w2, inv_z[:, 2:3])
        zpix = 1.0 / torch.clamp(iz, min=1e-12)
        ok = inside & (px >= 0) & (py >= 0) & (px < width) & (py < height)
        yield f, k, torch.where(ok, py * width + px, -1), ok, (w0, w1, w2), inv_z, zpix


def _raster_tier(pix, z, remaining, faces, width: int, height: int, tile: int, depth_flat):
    """Rasterize the faces of ``remaining`` whose box fits ``tile`` pixels
    into ``depth_flat`` (min z, in place); returns (depth_flat, fits). Only
    the covered pixels are scattered (no spare slot for the others: it would
    take an atomic of every uncovered pair)."""
    # a named range for torch.profiler (the tiers' share of device time)
    with torch.profiler.record_function(f"mesh_raster.tier{tile}"):
        fits, p, lo = _tier_fits(pix, remaining, faces, tile)
        for _, _, flat, ok, _, _, zpix in _tier_pixels(pix, z, fits, faces, lo, p, tile, width,
                                                       height):
            depth_flat.scatter_reduce_(0, flat[ok], zpix[ok], reduce="amin", include_self=True)
        return depth_flat, fits


def _project_vertices(camera, pose: SE3, mesh: OcclusionMesh, min_depth, max_depth):
    p_cam = pose.apply(mesh.vertices)
    pix, valid = cm.project(camera, p_cam)
    z = p_cam[:, 2]
    vert_ok = valid & (z >= min_depth) & (z <= max_depth)
    return pix, z, torch.all(vert_ok[mesh.faces], -1)


def _raster_depth(camera, pix, z, tri_valid, faces):
    width, height = camera.width, camera.height
    depth_flat = torch.full((height * width,), float("inf"), dtype=torch.float32, device=z.device)
    remaining = tri_valid
    for tile in TILES:
        depth_flat, done = _raster_tier(pix, z, remaining, faces, width, height, tile, depth_flat)
        remaining = remaining & ~done
    return depth_flat


def _edge_splat_pass(mesh: OcclusionMesh, camera, pose: SE3, depth, width: int, height: int,
                     splat_radius: float, num_samples: int = 8, max_radius_px: int = 4):
    """Mark occlusion-boundary neighbourhoods with -1 (the JAX pass is one
    ``jit``: its rotations and projections take their fused forms)."""
    cam_pos = -quat_rotate_fused(quat_conjugate(pose.q), pose.t)  # camera centre, global frame
    ep1 = mesh.vertices[mesh.edges[:, 0]]
    ep2 = mesh.vertices[mesh.edges[:, 1]]
    f1 = mesh.edge_faces[:, 0]
    f2 = mesh.edge_faces[:, 1]
    boundary = f2 < 0
    to_img = cam_pos[None, :] - ep1
    d1 = dot3_fused(mesh.face_normals[f1], to_img) > 0
    d2 = dot3_fused(mesh.face_normals[torch.clamp(f2, min=0)], to_img) > 0
    opp = mesh.edge_opposite
    silhouette = boundary | (opp & (d1 == d2)) | (~opp & (d1 != d2))
    c1 = pose.apply_fused(ep1)
    c2 = pose.apply_fused(ep2)
    act = torch.nonzero(silhouette & (c1[:, 2] > 0) & (c2[:, 2] > 0))[:, 0]
    c1, delta = c1[act], c2[act] - c1[act]
    length = torch.sqrt(dot3_fused(delta, delta))
    radius = torch.tensor(splat_radius, dtype=torch.float32, device=depth.device)
    count = 1 + torch.clamp(torch.floor(length / radius + 0.5), max=float(num_samples - 1))

    kthresh = 0.05
    depth_flat = depth.reshape(-1)
    n_px = depth_flat.shape[0]
    side = 2 * max_radius_px + 1
    k = torch.arange(side * side, device=depth.device)
    ody, odx = k // side - max_radius_px, k % side - max_radius_px
    ring = torch.maximum(torch.abs(odx), torch.abs(ody))
    mark = torch.zeros(n_px, dtype=torch.bool, device=depth.device)
    for i in range(num_samples):
        factor = i / torch.clamp(count - 1.0, min=1.0)
        pt = torch.addcmul(c1, factor[:, None], delta)  # (E,3)
        pix, valid = cm.project(camera, pt, fused=True)
        zc = pt[:, 2]
        ix = torch.clamp(torch.floor(pix[:, 0] + 0.5), -1, width).long()
        iy = torch.clamp(torch.floor(pix[:, 1] + 0.5), -1, height).long()
        inside = (i < count) & valid & (ix >= 0) & (iy >= 0) & (ix < width) & (iy < height)
        center = depth_flat[torch.clamp(iy, 0, height - 1) * width + torch.clamp(ix, 0, width - 1)]
        visible = inside & (center + kthresh >= zc)
        # pixel radius from the projection footprint
        eps = 1e-3 * torch.clamp(zc, min=1e-6)
        zero = torch.zeros_like(eps)
        pix2, _ = cm.project(camera, pt + torch.stack([eps, zero, zero], -1), fused=True)
        dp = pix2 - pix
        px_per_m = torch.sqrt(torch.addcmul(dp[:, 0] * dp[:, 0], dp[:, 1], dp[:, 1])) / eps
        r_px = torch.clamp(radius * px_per_m, 0.0, float(max_radius_px))
        hit = visible[:, None] & (ring[None, :] <= torch.ceil(r_px)[:, None])
        jx, jy = ix[:, None] + odx, iy[:, None] + ody
        okp = hit & (jx >= 0) & (jy >= 0) & (jx < width) & (jy < height)
        flat = torch.where(okp, jy * width + jx, 0)
        old = depth_flat[flat]
        should = okp & ((old == 0) | (old + kthresh > zc[:, None]))
        mark[flat[should]] = True
    return torch.where(mark, -1.0, depth_flat).reshape(height, width)


def render_occlusion_mesh_depth(camera, pose: SE3, mesh: OcclusionMesh,
                                splat_radius: float = 0.03,
                                min_depth: float = 0.05, max_depth: float = 100.0,
                                edge_splats: bool = True):
    """Full mesh occlusion depth: rasterize + boundary masking.

    Returns (H,W) float32: view z where covered, 0 for background, -1 near
    occlusion boundaries. Triangles projecting larger than the biggest tile
    are dropped (the mesh must be subdivided)."""
    width, height = camera.width, camera.height
    pix, z, tri_valid = _project_vertices(camera, pose, mesh, min_depth, max_depth)
    depth_flat = _raster_depth(camera, pix, z, tri_valid, mesh.faces)
    depth = torch.where(torch.isinf(depth_flat), 0.0, depth_flat).reshape(height, width)
    if edge_splats:
        depth = _edge_splat_pass(mesh, camera, pose, depth, width, height, splat_radius)
    return depth


def render_occlusion_mesh_depth_batch(camera, pose_q, pose_t, mesh: OcclusionMesh,
                                      splat_radius: float = 0.03, min_depth: float = 0.05,
                                      max_depth: float = 100.0, edge_splats: bool = True):
    """(B,H,W) occlusion depths for a batch of poses, one image at a time."""
    return torch.stack([
        render_occlusion_mesh_depth(camera, SE3(q, t), mesh, splat_radius=splat_radius,
                                    min_depth=min_depth, max_depth=max_depth,
                                    edge_splats=edge_splats)
        for q, t in zip(pose_q, pose_t)])


def render_mesh_depth_color(camera, pose: SE3, mesh: OcclusionMesh, vertex_colors,
                            min_depth: float = 0.05, max_depth: float = 100.0):
    """(depth (H,W), colour (H,W,3) float): the depth of
    :func:`render_occlusion_mesh_depth` without edge splats, and the
    perspective-correct interpolated vertex colour of a triangle whose depth
    at the pixel is within 1e-4 relative of the pixel's depth (the last such
    write in (tier, pixel offset, face) order, as the JAX CPU scatter keeps).
    Background pixels are 0."""
    width, height = camera.width, camera.height
    n_px = height * width
    F = mesh.faces.shape[0]
    pix, z, tri_valid = _project_vertices(camera, pose, mesh, min_depth, max_depth)
    depth_flat = _raster_depth(camera, pix, z, tri_valid, mesh.faces)
    cols = torch.as_tensor(vertex_colors, dtype=torch.float32, device=z.device)
    best = torch.full((n_px,), -1, dtype=torch.long, device=z.device)
    writes = []  # (flat, key, colour) of every winning write
    remaining = tri_valid
    for t, tile in enumerate(TILES):
        fits, p, lo = _tier_fits(pix, remaining, mesh.faces, tile)
        for f, k, flat, ok, (w0, w1, w2), inv_z, zpix in _tier_pixels(
                pix, z, fits, mesh.faces, lo, p, tile, width, height):
            dwin = depth_flat[torch.clamp(flat, 0, n_px - 1)]
            winner = ok & torch.isfinite(dwin) & (
                torch.abs(zpix - dwin) <= 1e-4 * torch.clamp(dwin, min=1e-6))
            fi, ki = torch.nonzero(winner, as_tuple=True)
            cf = cols[mesh.faces[f[fi]]]  # (M,3 vertices,3 channels)
            iz = inv_z[fi]
            u0, u1, u2 = (w[fi, ki, None] * cf[:, j] for j, w in enumerate((w0, w1, w2)))
            # perspective-correct: interpolate c/z and 1/z
            col = torch.addcmul(torch.addcmul(u1 * iz[:, 1:2], u0, iz[:, 0:1]),
                                u2, iz[:, 2:3]) * zpix[fi, ki, None]
            key = (t * TILES[-1] ** 2 + k[ki]) * F + f[fi]
            wflat = flat[fi, ki]
            best.scatter_reduce_(0, wflat, key, reduce="amax", include_self=True)
            writes.append((wflat, key, col))
        remaining = remaining & ~fits
    color_flat = torch.zeros((n_px, 3), dtype=torch.float32, device=z.device)
    for wflat, key, col in writes:
        last = key == best[wflat]
        color_flat[wflat[last]] = col[last]
    depth = torch.where(torch.isinf(depth_flat), 0.0, depth_flat)
    return depth.reshape(height, width), color_flat.reshape(height, width, 3)
