"""Build and load the hand-written CUDA kernels of ``../csrc``.

The ``.cu`` sources are compiled with ``nvcc`` for ``sm_90a`` (one process
per source, in parallel) and linked into one shared library with a plain C
interface, loaded with ``ctypes``. The build runs at
first use into ``build/torch_kernels/<hash>/`` beside the package (ignored by
git), keyed by a hash of the sources and the flags, so a fresh checkout
builds everything it needs and a second process reuses the library.

Nothing here runs at import: the CPU tests import every module, and a
CPU-only machine has no ``nvcc``. A missing compiler raises; there is no
fallback to the plain PyTorch versions for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's default prefix
COMPILE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_JAX = "dataset_pipeline_tpu/ops/pallas_gn.py"
_PROBE = "experiments/gather_probe"


class Kernel(NamedTuple):
    """One hand-written kernel: its C entry point with the argument types
    (pointers and the stream as void*, ints as int, 64-bit sizes as long
    long, floats as float), its source under ``csrc/``, the TPU kernel it replaces
    (file:line) and the launch counters of its wrapper. ``more`` maps the
    kernel's further C entry points (a second launch mode, the grid query of
    a persistent kernel) to their argument types."""

    entry: str
    argtypes: list
    source: str
    replaces: str
    counters: Tuple[str, ...]
    more: dict = {}


# the one table of the port's kernels: a new kernel is one row here
KERNELS = {
    "gn_fused": Kernel(  # B1, ops/gn.py:icp_hb_cost_fused and icp_cost_batch_fused
        "dpt_gn_fused", [_P, _I, _L, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
        "gn_fused.cu", f"{_JAX}:160", ("gn_fused", "gn_fused_cost_batch"),
        {"dpt_gn_cost_batch": [_P, _I, _L, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
         "dpt_gn_grid": []}),
    "moment_gram": Kernel(  # B2, ops/gn.py:moment_gram_partials
        "dpt_moment_gram", [_P, _I, _I, _I, _P, _I, _P],
        "moment_gram.cu", f"{_JAX}:360", ("moment_gram",), {"dpt_moment_gram_grid": []}),
    "pyramid_sample": Kernel(  # B3, ops/pyramid_sample.py:pyramid_sample and pair_rows
        "dpt_pyramid_sample", [_P, _L, _I, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P],
        "pyramid_sample.cu", "dataset_pipeline_tpu/ops/brick.py:135",
        ("pyramid_sample_derivs", "pyramid_sample_value", "pyramid_pairs"),
        {"dpt_pyramid_pairs": [_P, _L, _P, _L, _I, _P, _P, _P, _P, _I, _P]}),
    "gn_rows": Kernel(  # B4a, ops/gn.py:gn_rows
        "dpt_gn_rows", [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _P, _P, _P, _P],
        "gn_rows.cu", f"{_JAX}:34", ("gn_rows",), {"dpt_gn_rows_grid": [_I]}),
    "moment_gram48": Kernel(  # B4b, ops/gn.py:moment_gram48
        "dpt_moment_gram48", [_P, _I, _I, _I, _P, _I, _P],
        "moment_gram48.cu", f"{_JAX}:270", ("moment_gram48",)),
    "moment_gram_thirds": Kernel(  # B4c, ops/gn.py:moment_gram_thirds
        "dpt_moment_gram_thirds", [_P, _I, _I, _I, _P, _I, _P],
        "moment_gram_thirds.cu", f"{_JAX}:322", ("moment_gram_thirds",)),
    "moment_gram_repeat": Kernel(  # B5a, ops/gn.py:moment_gram_repeat
        "dpt_moment_gram_repeat", [_P, _I, _I, _I, _P, _I, _I, _P],
        "moment_gram_repeat.cu", f"{_JAX}:420", ("moment_gram_repeat",)),
    "hbm_read_sum": Kernel(  # B5b, ops/hbm.py:hbm_read_sum
        "dpt_hbm_read_sum", [_P, _L, _I, _P, _I, _P, _P, ctypes.POINTER(_I), _P],
        "hbm_read_sum.cu", "bench.py:155", ("hbm_read_sum",),
        {"dpt_hbm_read_sum_grid": []}),
    "take_along_lanes": Kernel(  # E1, ops/gather.py:take_along_lanes
        "dpt_take_along_lanes", [_P, _P, _P, _I, _I, _I, _P],
        "gather_probes.cu", f"{_PROBE}.py:49", ("take_along_lanes",)),
    "take_along_sublanes": Kernel(  # E2, ops/gather.py:take_along_sublanes
        "dpt_take_along_sublanes", [_P, _P, _P, _I, _I, _I, _I, _P],
        "gather_probes.cu", f"{_PROBE}.py:69", ("take_along_sublanes",)),
    "take_rows": Kernel(  # E3, ops/gather.py:take_rows
        "dpt_take_rows", [_P, _P, _P, _I, _I, _I, _I, _P],
        "gather_probes.cu", f"{_PROBE}.py:89", ("take_rows",)),
    "advanced_2d": Kernel(  # E4, ops/gather.py:advanced_2d
        "dpt_advanced_2d", [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "gather_probes.cu", f"{_PROBE}.py:109", ("advanced_2d",)),
    "tile_gather": Kernel(  # E5, ops/gather.py:tile_gather
        "dpt_tile_gather", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "tile_gather.cu", f"{_PROBE}.py:237", ("tile_gather",)),
    "row_extract": Kernel(  # E6, ops/gather.py:row_extract
        "dpt_row_extract", [_P, _P, _P, _P, _P, _P, _L, _I, _P],
        "row_extract.cu", f"{_PROBE}2.py:121", ("row_extract",)),
    "row_extract_packed": Kernel(  # E7, ops/gather.py:row_extract_packed
        "dpt_row_extract_packed", [_P] * 10 + [_L, _I, _I, _I, _P],
        "row_extract_packed.cu", f"{_PROBE}2.py:251", ("row_extract_packed",),
        {"dpt_row_extract_packed_grid": []}),
    "hb_geometry": Kernel(  # ops/hb_geometry.py:project and jacobian
        "dpt_hb_geometry_project", [_P, _P, _P, _I, _P, _F, _P, _I, _L, _I, _P, _P, _P],
        "hb_geometry.cu", "dataset_pipeline_tpu/photometric/optimizer.py:797",
        ("hb_geometry_project", "hb_geometry_jacobian"),
        {"dpt_hb_geometry_jacobian": [_P, _P, _P, _I, _P, _I, _L, _I, _P, _P, _P, _F, _I, _I, _P,
                                      _P]}),
    "hb_gram": Kernel(  # ops/hb_gram.py:gram_assemble
        "dpt_hb_gram", [_P, _I, _P, _P, _P, _I, _P, _I, _P, _L, _I, _I, _I, _F, _F, _P, _P, _P, _P,
                        _P, _P],
        "hb_gram.cu", "dataset_pipeline_tpu/photometric/optimizer.py:395", ("hb_gram",),
        {"dpt_hb_gram_grid": [_I], "dpt_hb_gram_record": [_I]}),
}

# kernel launches per wrapper variant (never the plain versions): a run
# resets them and reads them after, to show which kernels it went through
LAUNCHES = {c: 0 for k in KERNELS.values() for c in k.counters}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_lib = None
build_info: dict = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default prefix; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        f"nvcc not found (looked in $CUDA_HOME/bin, PATH and {DEFAULT_NVCC}):"
        " the CUDA kernels of dataset_pipeline_tpu_torch cannot be built."
        " CUDA tensors have no fallback; use CPU tensors for the plain versions.")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless this source hash is already built; returns
    its path. Fills ``build_info`` (seconds, cached, ptxas report)."""
    nvcc = find_nvcc()
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libdpt_kernels.so"
    log_path = out_dir / "nvcc.log"
    if lib_path.exists():
        build_info.update(seconds=0.0, cached=True, path=str(lib_path),
                          log=log_path.read_text() if log_path.exists() else "")
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # one nvcc per source, all started together, then one link
    objs, procs = [], []
    for cu in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{cu.stem}.{os.getpid()}.o"
        objs.append(str(obj))
        procs.append(subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(cu)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = [(pr.communicate()[0], pr.returncode) for pr in procs]
    log = "".join(o for o, _ in outs)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    rc = max(r for _, r in outs)
    if rc == 0:
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp, *objs], capture_output=True,
                              text=True)
        log += link.stdout + link.stderr
        rc = link.returncode
    for obj in objs:
        if os.path.exists(obj):
            os.unlink(obj)
    seconds = time.perf_counter() - t0
    if rc != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({rc}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib_path)  # atomic: a concurrent process sees all or nothing
    build_info.update(seconds=seconds, cached=False, path=str(lib_path), log=log)
    return lib_path


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Give every entry point of the table its argument types (without them
    ctypes passes a pointer as a 32-bit int)."""
    for k in KERNELS.values():
        for entry, argtypes in {k.entry: k.argtypes, **k.more}.items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.dpt_error_string.argtypes = [ctypes.c_int]
    lib.dpt_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib


_grids: dict = {}
_scratch: dict = {}


def scratch(name: str, device, stream: int, floats: int, ints: int):
    """``(float32 (>= floats,), int32 (>= ints,), ticket int32 (1,))`` that the
    persistent kernel ``name`` keeps from call to call on one device and
    stream, so that a call allocates nothing but its output. Launches on one
    stream run in order, so the next call may overwrite what the last one
    left; the ticket is zero when made and every launch leaves it zero."""
    import torch

    key = (name, torch.device(device).index, stream)
    held = _scratch.get(key)
    if held is None or held[0].numel() < floats or held[1].numel() < ints:
        held = (torch.empty(floats, dtype=torch.float32, device=device),
                torch.empty(max(ints, 1), dtype=torch.int32, device=device),
                held[2] if held else torch.zeros(1, dtype=torch.int32, device=device))
        _scratch[key] = held
    return held


def persistent_grid(query: str, device, *args) -> int:
    """Blocks of a persistent launch on ``device``: what the entry point
    ``query`` reports for ``args`` (SM count x resident blocks per SM), asked
    once per device, kernel and arguments."""
    import torch

    index = torch.device(device).index
    key = (query, torch.cuda.current_device() if index is None else index, *args)
    if key not in _grids:
        with torch.cuda.device(key[1]):
            n = getattr(library(), query)(*args)
        if n <= 0:
            check(-n if n < 0 else 1, query)
        _grids[key] = n
    return _grids[key]


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by an entry point."""
    if err != 0:
        msg = _lib.dpt_error_string(err).decode() if _lib is not None else ""
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
