"""Plain reference of the GroundTruthCreator's per-image products on the DSLR scene.

Written from the tool's definition (``README.md``: occlusion geometry, the
2-view filter, ground-truth depth), with torch only, for PINHOLE cameras, in
float64 (or, as the control, float32 with TF32 matrix products):

- occlusion from splats: every scan point with a camera-frame depth in [0.05,
  100] m is a square splat (geometry.splat_depth); inf where empty;
- occlusion from a mesh: every triangle whose three vertices project in
  front within [0.05, 100] m and whose screen box spans at most 32 pixels a
  side covers the pixel centres inside it (closed), at the perspective-correct
  depth 1 / (sum_i w_i / z_i); the nearest wins, 0 where none does; then
  around every silhouette edge (an edge with one face, or whose two faces
  face the camera differently) up to eight samples along the edge, each a
  square of ``ceil(r_px)`` pixels (r_px from the splat radius, at most 4) set
  to -1 where the pixel is background or not in front of the sample by 5 cm;
- visibility of a scan point: projected to the nearest pixel inside the
  image, in front, and not behind the occlusion depth there by more than 1 cm;
- the view counts, the >= 2-view keep, and the ground-truth depth: the
  nearest visible kept point per pixel, inf where none.
"""

from __future__ import annotations

import torch

from perfbench.reference.geometry import Prec, project, quat_to_matrix, splat_depth, transform, zbuffer

MIN_DEPTH, MAX_DEPTH = 0.05, 100.0
THRESHOLD = 0.01  # occlusion slack of the visibility test
EDGE_SAMPLES, EDGE_MAX_PX, EDGE_SLACK = 8, 4, 0.05
TILE_MAX = 32
FACE_CHUNK = 1 << 16


def mesh_edges(faces):
    """Undirected edges of a triangle mesh with their faces: (edges (E, 2)
    vertex ids, face ids (E, 2) with -1 for a boundary edge, and whether the
    two faces run the edge the same way, i.e. are wound oppositely)."""
    F = faces.shape[0]
    half = torch.cat([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    face = torch.arange(F, device=faces.device).repeat(3)
    lo, hi = half.min(1).values, half.max(1).values
    forward = half[:, 0] < half[:, 1]
    key = lo * (int(faces.max()) + 1) + hi
    key, order = torch.sort(key, stable=True)
    uniq, counts = torch.unique_consecutive(key, return_counts=True)
    if int(counts.max()) > 2:
        raise ValueError("the reference takes manifold meshes only")
    start = torch.cumsum(counts, 0) - counts
    first = order[start]
    second = torch.where(counts == 2, order[torch.clamp(start + 1, max=key.numel() - 1)], -1)
    edges = torch.stack([lo[first], hi[first]], -1)
    faces2 = torch.stack([face[first], torch.where(second >= 0, face[second.clamp(min=0)], -1)], -1)
    same_way = (second >= 0) & (forward[first] == forward[second.clamp(min=0)])
    return edges, faces2, same_way


class GroundTruthReference:
    """The tool's per-image products on ``scene`` (perfbench.scene.dslr) at
    the true poses, with the settings of configuration ``cfg`` (its
    ``ground_truth`` group)."""

    def __init__(self, scene, cfg: dict, prec: Prec, occlusion: str):
        self.prec, self.cfg, self.occlusion_kind = prec, cfg, occlusion
        self.W, self.H = scene.width, scene.height
        p = prec.cast(scene.params)
        self.fx, self.fy, self.cx, self.cy = p[0], p[1], p[2], p[3]
        self.R = quat_to_matrix(scene.q_true.double())
        self.t = scene.t_true.double()
        self.scan = scene.scan
        self.B = scene.images.shape[0]
        if occlusion == "mesh":
            self.verts, self.faces = scene.mesh_vertices, scene.mesh_faces
            self.edges, self.edge_faces, self.same_way = mesh_edges(self.faces)
            v = self.verts.double()[self.faces]
            n = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], dim=-1)
            self.normals = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-30)

    def _cam(self, pts, b):
        return transform(pts, self.R[b], self.t[b], self.prec)

    # -- occlusion -----------------------------------------------------------------

    def occlusion_depth(self, b: int):
        if self.occlusion_kind == "mesh":
            return self._mesh_depth(b)
        p = self._cam(self.scan, b)
        z = p[:, 2]
        p = torch.where(((z >= MIN_DEPTH) & (z <= MAX_DEPTH))[:, None], p,
                        torch.tensor([0.0, 0.0, -1.0], dtype=p.dtype, device=p.device))
        return splat_depth(p, self.fx, self.fy, self.cx, self.cy, self.W, self.H,
                           self.cfg["splat_radius"], self.cfg["max_radius_px"])

    def _mesh_depth(self, b: int):
        W, H = self.W, self.H
        p = self._cam(self.verts, b)
        x, y, front = project(p, self.fx, self.fy, self.cx, self.cy)
        z = p[:, 2]
        vok = front & (z >= MIN_DEPTH) & (z <= MAX_DEPTH)
        depth = torch.full((H * W,), float("inf"), dtype=p.dtype, device=p.device)
        for f0 in range(0, self.faces.shape[0], FACE_CHUNK):
            fc = self.faces[f0:f0 + FACE_CHUNK]
            ok = vok[fc].all(1)
            fx_, fy_, fz = x[fc], y[fc], z[fc]
            lox, loy = torch.floor(fx_.min(1).values), torch.floor(fy_.min(1).values)
            ext = torch.maximum(torch.ceil(fx_.max(1).values) - lox, torch.ceil(fy_.max(1).values) - loy) + 1
            area = ((fx_[:, 1] - fx_[:, 0]) * (fy_[:, 2] - fy_[:, 0])
                    - (fy_[:, 1] - fy_[:, 0]) * (fx_[:, 2] - fx_[:, 0]))
            ok = ok & (ext <= TILE_MAX) & (area.abs() > 1e-12)
            for tile in (8, TILE_MAX):
                sel = torch.nonzero(ok & (ext <= tile) & (ext > (8 if tile == TILE_MAX else 0)))[:, 0]
                if sel.numel() == 0:
                    continue
                k = torch.arange(tile * tile, device=p.device)
                px = lox[sel, None] + (k % tile)
                py = loy[sel, None] + torch.div(k, tile, rounding_mode="floor")
                ax, ay = fx_[sel, 0, None], fy_[sel, 0, None]
                bx, by = fx_[sel, 1, None], fy_[sel, 1, None]
                cx, cy = fx_[sel, 2, None], fy_[sel, 2, None]
                inv = 1.0 / area[sel, None]
                w0 = ((bx - px) * (cy - py) - (by - py) * (cx - px)) * inv
                w1 = ((cx - px) * (ay - py) - (cy - py) * (ax - px)) * inv
                w2 = 1.0 - w0 - w1
                inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
                inside = inside & (px >= 0) & (py >= 0) & (px < W) & (py < H)
                iz = w0 / fz[sel, 0, None] + w1 / fz[sel, 1, None] + w2 / fz[sel, 2, None]
                zp = 1.0 / torch.clamp(iz, min=1e-12)
                pix = torch.where(inside, py.long() * W + px.long(), -1)
                depth = torch.minimum(depth, zbuffer(pix.reshape(-1), zp.reshape(-1), H * W))
        depth = torch.where(torch.isinf(depth), 0.0, depth)
        return self._edge_marks(depth, b).reshape(H, W)

    def _edge_marks(self, depth, b: int):
        """Set to -1 the pixels near silhouette edges (read against the
        unmarked depth)."""
        W, H = self.W, self.H
        R, t = self.R[b], self.t[b]
        centre = -(R.T @ t)
        e0, e1 = self.edges[:, 0], self.edges[:, 1]
        v = self.verts.double()
        to_cam = centre[None] - v[e0]
        f1, f2 = self.edge_faces[:, 0], self.edge_faces[:, 1]
        d1 = (self.normals[f1] * to_cam).sum(1) > 0
        d2 = (self.normals[f2.clamp(min=0)] * to_cam).sum(1) > 0
        sil = (f2 < 0) | (self.same_way & (d1 == d2)) | (~self.same_way & (d1 != d2))
        c1, c2 = self._cam(self.verts[e0], b), self._cam(self.verts[e1], b)
        act = sil & (c1[:, 2] > 0) & (c2[:, 2] > 0)
        c1, delta = c1[act], c2[act] - c1[act]
        count = 1 + torch.clamp(torch.floor(torch.linalg.vector_norm(delta, dim=-1)
                                            / self.cfg["splat_radius"] + 0.5), max=EDGE_SAMPLES - 1)
        side = 2 * EDGE_MAX_PX + 1
        k = torch.arange(side * side, device=depth.device)
        oy, ox = torch.div(k, side, rounding_mode="floor") - EDGE_MAX_PX, k % side - EDGE_MAX_PX
        ring = torch.maximum(ox.abs(), oy.abs())
        mark = torch.zeros(H * W, dtype=torch.bool, device=depth.device)
        for i in range(EDGE_SAMPLES):
            pt = c1 + (i / torch.clamp(count - 1, min=1))[:, None] * delta
            x, y, front = project(pt, self.fx, self.fy, self.cx, self.cy)
            zc = pt[:, 2]
            ix, iy = torch.floor(x + 0.5), torch.floor(y + 0.5)
            inside = (i < count) & front & (ix >= 0) & (iy >= 0) & (ix < W) & (iy < H)
            centre_d = depth[(iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).long()]
            seen = inside & (centre_d + EDGE_SLACK >= zc)
            r_px = torch.clamp(self.cfg["splat_radius"] * self.fx / zc, 0, EDGE_MAX_PX)
            hit = seen[:, None] & (ring[None] <= torch.ceil(r_px)[:, None])
            jx, jy = ix[:, None] + ox, iy[:, None] + oy
            okp = hit & (jx >= 0) & (jy >= 0) & (jx < W) & (jy < H)
            flat = torch.where(okp, jy * W + jx, 0).long()
            old = depth[flat]
            mark[flat[okp & ((old == 0) | (old + EDGE_SLACK > zc[:, None]))]] = True
        return torch.where(mark, -1.0, depth)

    # -- visibility and ground truth -------------------------------------------------

    def visible(self, b: int, occl):
        """Scan points visible in image b against its occlusion depth (H, W):
        (visible (M,), flat pixel (M,), z (M,))."""
        p = self._cam(self.scan, b)
        x, y, front = project(p, self.fx, self.fy, self.cx, self.cy)
        z = p[:, 2]
        ix, iy = torch.floor(x + 0.5), torch.floor(y + 0.5)
        inside = front & (ix >= 0) & (iy >= 0) & (ix < self.W) & (iy < self.H)
        pix = (iy.clamp(0, self.H - 1) * self.W + ix.clamp(0, self.W - 1)).long()
        vis = inside & (z > 0) & (occl.reshape(-1)[pix] + THRESHOLD >= z)
        return vis, pix, z

    def products(self):
        """(occlusion depths (B, H, W), view counts (M,), keep (M,),
        ground-truth depths (B, H, W)), all on the device."""
        occl = torch.stack([self.occlusion_depth(b) for b in range(self.B)])
        counts = torch.zeros(self.scan.shape[0], dtype=torch.int32, device=self.scan.device)
        for b in range(self.B):
            counts += self.visible(b, occl[b])[0]
        keep = counts >= 2
        gt = []
        for b in range(self.B):
            vis, pix, z = self.visible(b, occl[b])
            gt.append(zbuffer(torch.where(vis & keep, pix, -1), z, self.H * self.W).reshape(self.H, self.W))
        return occl, counts, keep, torch.stack(gt)
