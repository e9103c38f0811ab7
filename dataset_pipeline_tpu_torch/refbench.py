"""Measured single-core CPU baselines: the reference's inner loops in C++.

The reference's own binaries need libraries this project does not carry
(Eigen, PCL, Boost, Glog, opengv, ...), so three dependency-free C++ files
mirror its hot loops line for line:

- ``csrc/ref_icp_loop.cc``: the point-to-plane H, b, cost accumulation of
  ``icp_point_to_plane_impl.h:115-211`` (global transforms per
  correspondence, the symmetric residual pair, upper-triangular double sums);
- ``csrc/ref_photo_loop.cc``: the photometric descriptor H, b accumulation
  (PINHOLE, trilinear sampling + chain rule, Huber-weighted rows);
- ``csrc/ref_render_loops.cc``: one cube-map face (projection, z-buffer,
  median fill-in, colour flood) and one ground-truth depth frame (>= 2
  observations, occlusion z-test, min-z).

They are the port's copies, byte for byte, of the JAX package's
``native/ref_*.cc`` (a test holds them equal), built with the reference's
own optimisation flags ``-O2 -msse2 -msse3`` (its CMakeLists.txt:82) and run
single-threaded, as the reference's loops are. The libraries land in
``build/native/<source hash>/`` beside the package (ignored by git). Nothing
of the device path calls them: they give the measurement tools a measured
reference rate. Without ``g++`` each function returns None, as the JAX
package's do; a compiler that fails raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
BUILD_ROOT = _PKG.parent / "build" / "native"
# the reference's own flags (CMakeLists.txt:82) + shared-library necessities
REF_FLAGS = ["-O2", "-msse2", "-msse3"]
_CXX = ["g++", "-std=c++14", *REF_FLAGS, "-shared", "-fPIC"]
SOURCES = {name: _PKG / "csrc" / f"ref_{name}.cc" for name in ("icp_loop", "photo_loop", "render_loops")}

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
_c = ctypes
# C entry points per source: (name, restype, argtypes)
_ENTRIES = {
    "icp_loop": [("ref_icp_inner", _c.c_double,
                  [_f32p, _f32p, _f32p, _f32p, _c.c_long, _c.c_long, _f32p, _f32p, _c.c_int,
                   _f64p, _f64p, _f64p])],
    "photo_loop": [("ref_photo_inner", _c.c_double,
                    [_f32p, _i32p, _f32p, _c.c_long, _c.c_int, _f32p, _c.c_int, _c.c_int,
                     _f32p, _c.c_int, _c.c_int, _f32p, _c.c_float, _c.c_float, _c.c_float,
                     _c.c_int, _f64p, _f64p, _f64p, _i64p])],
    "render_loops": [("ref_cubemap_face", None,
                      [_f32p, _u8p, _c.c_longlong, _f64p, _c.c_float, _c.c_float, _c.c_float,
                       _c.c_float, _c.c_int, _c.c_int, _f32p, _u8p]),
                     ("ref_gt_depth_frame", None,
                      [_f32p, _i32p, _c.c_longlong, _f64p, _c.c_float, _c.c_float, _c.c_float,
                       _c.c_float, _c.c_int, _c.c_int, _f32p, _c.c_float, _f32p])],
}
_libs: dict = {}


def build(name: str) -> Optional[Path]:
    """Compile ``csrc/ref_<name>.cc`` unless this source hash is built;
    returns the library path, or None when ``g++`` is missing."""
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(_CXX).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / digest
    so = out_dir / f"libref_{name}.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run([*_CXX, str(src), "-o", tmp], capture_output=True, text=True)
    except FileNotFoundError:
        os.unlink(tmp)
        return None
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on {src} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent process sees all or nothing
    return so


def _lib(name: str) -> Optional[ctypes.CDLL]:
    if name not in _libs:
        so = build(name)
        lib = None if so is None else ctypes.CDLL(str(so))
        for entry, restype, argtypes in (_ENTRIES[name] if lib is not None else ()):
            fn = getattr(lib, entry)
            fn.restype, fn.argtypes = restype, argtypes
        _libs[name] = lib
    return _libs[name]


def _f32(a):
    return np.ascontiguousarray(a, np.float32)


def ref_icp_inner(ps, ns, pt, nt, R=None, t=None, iters: int = 1,
                  ) -> Optional[Tuple[float, np.ndarray, np.ndarray, float]]:
    """Run ``iters`` reference-style H, b, cost accumulations over the M
    correspondences (first half cloud 0 -> cloud 1, second half reversed).
    Returns (seconds, H (6,6) upper triangle, b (6,), cost) or None without
    a compiler."""
    lib = _lib("icp_loop")
    if lib is None:
        return None
    M = len(ps)
    if R is None:
        R = np.tile(np.eye(3, dtype=np.float32)[None], (2, 1, 1))
    if t is None:
        t = np.zeros((2, 3), np.float32)
    H = np.zeros((6, 6), np.float64)
    b = np.zeros(6, np.float64)
    cost = np.zeros(1, np.float64)
    secs = lib.ref_icp_inner(_f32(ps), _f32(ns), _f32(pt), _f32(nt), M, M // 2,
                             _f32(R).reshape(-1), _f32(t).reshape(-1), iters, H, b, cost)
    return secs, H, b, float(cost[0])


def ref_photo_inner(pts, neighbors, desc, lv0, lv1, scale_z, f, cx, cy, iters: int = 1):
    """Time ``iters`` reference-style photometric H, b accumulation passes
    (PINHOLE, trilinear + chain rule + Huber descriptor rows). Returns
    (seconds, observation count) or None without a compiler."""
    lib = _lib("photo_loop")
    if lib is None:
        return None
    N, K = neighbors.shape
    H = np.zeros((10, 10), np.float64)
    b = np.zeros(10, np.float64)
    cost = np.zeros(1, np.float64)
    count = np.zeros(1, np.int64)
    secs = lib.ref_photo_inner(
        _f32(pts), np.ascontiguousarray(neighbors, np.int32), _f32(desc), N, K,
        _f32(lv0), lv0.shape[1], lv0.shape[0], _f32(lv1), lv1.shape[1], lv1.shape[0],
        _f32(scale_z), f, cx, cy, iters, H, b, cost, count)
    return secs, int(count[0])


def ref_cubemap_face(points, colors, R, fx, fy, cx, cy, width, height):
    """One reference cube-map face render (project + z-buffer + median
    fill-in + colour flood). Returns (depth (H,W), colour (H,W,3)) or None
    without a compiler. Time the call from outside."""
    lib = _lib("render_loops")
    if lib is None:
        return None
    depth = np.zeros((height, width), np.float32)
    color = np.zeros((height, width, 3), np.uint8)
    lib.ref_cubemap_face(_f32(points), np.ascontiguousarray(colors, np.uint8), len(points),
                         np.ascontiguousarray(R, np.float64).reshape(-1),
                         fx, fy, cx, cy, width, height, depth, color)
    return depth, color


def ref_gt_depth_frame(points, obs_counts, T34, fx, fy, cx, cy, width, height, occlusion,
                       threshold=0.01):
    """One reference ground-truth depth frame (>= 2-observation trim +
    occlusion z-test + min-z). Returns depth (H,W) or None without a
    compiler. Time the call from outside."""
    lib = _lib("render_loops")
    if lib is None:
        return None
    depth = np.zeros((height, width), np.float32)
    lib.ref_gt_depth_frame(_f32(points), np.ascontiguousarray(obs_counts, np.int32), len(points),
                           np.ascontiguousarray(T34, np.float64).reshape(-1),
                           fx, fy, cx, cy, width, height, _f32(occlusion), threshold, depth)
    return depth
