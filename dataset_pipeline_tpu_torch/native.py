"""Host kernels of the port: the grid kNN, the greedy merge and the
triangle-grid insertion.

``csrc/gridder.cc`` is the port's own copy, byte for byte, of the JAX
package's native gridder source (a test holds the two files equal),
compiled with that package's loader's exact flags, so merged positions and
neighbor lists agree bit for bit with the JAX package while the port needs
no file of it. The library lands in ``build/native/<source hash>/`` beside the package
(ignored by git) and is reused by later processes.

Only ``grid_knn``, ``greedy_merge`` and ``insert_triangles`` are exposed. A
missing compiler raises: the JAX side's fallbacks (a voxel merge that gives
other levels, a Python insertion loop) are not ported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "gridder.cc"
BUILD_ROOT = _PKG.parent / "build" / "native"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lib = None


def build() -> Path:
    """Compile ``gridder.cc`` unless this source hash is built; returns the
    library path. Raises when the compiler is missing or fails."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / digest
    so = out_dir / "libgridder.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError("g++ not found: the native gridder cannot be built") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on {SOURCE} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent process sees all or nothing
    return so


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        lib.greedy_merge.restype = ctypes.c_int64
        lib.greedy_merge.argtypes = [
            f32p, f32p, u8p, f32p, ctypes.c_int64, ctypes.c_float,
            ctypes.c_int32, f32p, f32p, u8p, f32p,
        ]
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        lib.insert_triangles.restype = ctypes.c_int64
        lib.insert_triangles.argtypes = [
            i64p, i64p, ctypes.c_int64, i64p, ctypes.c_int32, i32p, i32p, ctypes.c_int64,
        ]
        lib.grid_knn.restype = ctypes.c_int32
        lib.grid_knn.argtypes = [
            f32p, ctypes.c_int64, f32p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_float, i32p, f32p,
        ]
        _lib = lib
    return _lib


def grid_knn(points: np.ndarray, queries: np.ndarray, k: int,
             skip_self: bool = False, cell_hint: float = 0.0):
    """Exact threaded kNN over a uniform grid with expanding-ring probes.
    Returns (d2 (Q,k) float32 ascending, idx (Q,k) int32, -1 padded).
    ``skip_self`` excludes the identically-indexed point."""
    lib = get_lib()
    pts = np.ascontiguousarray(points, np.float32)
    qs = np.ascontiguousarray(queries, np.float32)
    n, q = len(pts), len(qs)
    k = int(min(k, n))
    out_idx = np.empty((q, k), np.int32)
    out_d2 = np.empty((q, k), np.float32)
    rc = lib.grid_knn(pts, n, qs, q, k, 1 if skip_self else 0,
                      np.float32(cell_hint), out_idx, out_d2)
    if rc != 0:
        raise RuntimeError(f"grid_knn failed ({rc})")
    return out_d2, out_idx


def insert_triangles(lo_cells: np.ndarray, hi_cells: np.ndarray, dims,
                     max_per_cell: int) -> np.ndarray:
    """Triangle ids per grid cell, in face order, -1 padded: (num_cells,
    max_per_cell) int32 from each face's inclusive cell box ``lo``..``hi``
    (F,3); a full cell drops later faces."""
    lib = get_lib()
    dims = np.ascontiguousarray(dims, np.int64)
    num_cells = int(dims[0] * dims[1] * dims[2])
    table = np.full((num_cells, max_per_cell), -1, np.int32)
    counts = np.zeros(num_cells, np.int32)
    lib.insert_triangles(
        np.ascontiguousarray(lo_cells, np.int64), np.ascontiguousarray(hi_cells, np.int64),
        len(lo_cells), dims, max_per_cell, table, counts, num_cells,
    )
    return table


def greedy_merge(points: np.ndarray, colors: np.ndarray, scan_indices: np.ndarray,
                 max_radius: np.ndarray, merge_distance: float, num_scans: int):
    """Reference-semantics greedy radius merge: (points, intensities,
    scan_indices, max_radius) of the merged set."""
    lib = get_lib()
    n = len(points)
    out_pts = np.empty((max(n, 1), 3), np.float32)
    out_col = np.empty(max(n, 1), np.float32)
    out_scan = np.empty(max(n, 1), np.uint8)
    out_mr = np.empty(max(n, 1), np.float32)
    m = lib.greedy_merge(
        np.ascontiguousarray(points, np.float32),
        np.ascontiguousarray(colors, np.float32),
        np.ascontiguousarray(scan_indices, np.uint8),
        np.ascontiguousarray(max_radius, np.float32),
        n, np.float32(merge_distance), num_scans,
        out_pts, out_col, out_scan, out_mr,
    )
    return out_pts[:m].copy(), out_col[:m].copy(), out_scan[:m].copy(), out_mr[:m].copy()
