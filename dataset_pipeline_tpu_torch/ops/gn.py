"""ICP Gauss-Newton kernels (B1, B2, B4a, B4b, B4c, B5a) and their plain versions.

Counterpart of ``dataset_pipeline_tpu/ops/pallas_gn.py``. ``kernels.KERNELS``
is the table of the port's kernels (entry point, source, the TPU kernel
each replaces, launch counters); the wrappers here are

- ``icp_hb_cost_fused`` (B1) and ``icp_hb_cost_rows`` / ``gn_rows`` (B4a):
  H, b, cost of the symmetric point-to-plane residuals, fused from the
  packed tensor with per-chunk cloud pairs, or from precomputed Jacobian
  rows with per-row cloud ids; ``icp_cost_batch_fused`` (B1's second launch
  mode): the cost alone under K candidate pose sets in one pass;
- ``moment_gram_partials`` (B2), ``moment_gram48`` (B4b),
  ``moment_gram_thirds`` (B4c) and ``moment_gram_repeat`` (B5a, the timing
  harness): the monomial moment Gram of the packed tensor.

The packed correspondence tensor is ``data (rows >= 13, Mp)`` float32, one
column per correspondence: rows ``[ps(3); ns(3); pt(3); nt(3); w]`` in the
clouds' local frames, grouped so that every ``chunk`` columns belong to one
ordered cloud pair (``icp/moments.py:pack_group_data``; padding columns have
``w = 0``).

Each wrapper takes the plain PyTorch version for a tensor on the CPU and
launches its hand-written CUDA kernel (``csrc/``) for a CUDA tensor; any
other device raises, and so does a CUDA call whose kernel cannot be built.
``LAUNCHES`` (``kernels.LAUNCHES``, one dict for every kernel of the port)
counts the kernel launches of each wrapper, never the plain versions, so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

import torch

from dataset_pipeline_tpu_torch.kernels import LAUNCHES, reset_launch_counts  # noqa: F401
from dataset_pipeline_tpu_torch.models.lie import quat_rotate, quat_to_matrix

PACKED_ROWS = 13  # rows the kernels read: ps, ns, pt, nt, w
N_MONO = 42
# the least work one correspondence's Gram needs: the monomials are a
# Kronecker product a (x) b, so the 42x42 Gram has 28 x 21 distinct sums
# (vech(a a^T) by w vech(n n^T)): 588 FMAs, and the 48 products that build
# the 28 + 21 factors (csrc/moment_gram.cuh)
MOMENT_FLOPS_PER_ROW = 2 * 588 + 48

GN_MAX_CANDIDATES = 10  # pose sets of one cost batch (csrc/gn_fused.cu: kMaxCands)
_GN_MAX_CLOUDS = 64  # poses the B1 kernels hold in shared memory (kMaxClouds)
_GN_UNIT = 128  # columns a warp of the B1 kernels takes per trip
_MOMENT_TILE = 256  # rows staged per pass by the B2 kernel
_MOMENT_MIN_ROWS = 4096  # rows per block of the B2 kernel, at least (where the chunk allows):
# a block's fixed costs (its first copies' latency, its reduction) stay small against its loop
_MOMENT_MAX_ROWS = 16384  # ... and at most
_ROWS_SUMS = 28  # sums a B4a record holds per cloud-pair class (csrc/gn_rows.cu)
_ROWS_MAX_CLOUDS = 21  # its warps' class tables fit a block's 227 KB of shared memory up to here
_ROWS_PLAIN_CHUNK = 65536  # columns per product of the B4a plain version


def pack_icp_inputs(ps, ns, pt, nt, w, chunk: int = 16384, rows: int = 16):
    """Pack (M,3) correspondences into the ``(rows, Mp)`` layout, Mp padded to
    a multiple of ``chunk`` (the packed tensor is pose-independent)."""
    M = ps.shape[0]
    Mp = M + (-M) % chunk
    data = torch.zeros((rows, Mp), dtype=torch.float32, device=ps.device)
    data[0:3, :M] = ps.T
    data[3:6, :M] = ns.T
    data[6:9, :M] = pt.T
    data[9:12, :M] = nt.T
    data[12, :M] = w
    return data


def _check_packed(data, chunk: int):
    if data.dtype != torch.float32 or data.dim() != 2 or data.shape[0] < PACKED_ROWS:
        raise ValueError(f"packed data must be float32 (>= {PACKED_ROWS}, Mp); "
                         f"got {data.dtype} {tuple(data.shape)}")
    if not data.is_contiguous():
        raise ValueError("packed data must be contiguous")
    Mp = data.shape[1]
    if chunk <= 0 or Mp == 0 or Mp % chunk != 0:
        raise ValueError(f"Mp={Mp} must be a positive multiple of chunk={chunk}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")
    return Mp // chunk


# ---------------------------------------------------------------------------
# B1: fused H, b, cost
# ---------------------------------------------------------------------------


def _posed_plain(q, t, data, chunk_pairs, chunk: int):
    """Per chunk and column: the posed points and normals, the residuals and
    the weights, ``(ps, ns, pt, nt, r1, r2, w)`` with each vector a list of
    three ``(G, chunk)`` tensors in ``data.dtype``."""
    G = data.shape[1] // chunk
    d = data[:PACKED_ROWS].reshape(PACKED_ROWS, G, chunk)
    R = quat_to_matrix(q.to(data.dtype))
    tr = t.to(data.dtype)
    s, tg = chunk_pairs[:, 0].long(), chunk_pairs[:, 1].long()

    def pose(rows, Rc, tc):
        v = d[rows:rows + 3]  # (3,G,chunk)
        out = [Rc[:, i, 0, None] * v[0] + Rc[:, i, 1, None] * v[1]
               + Rc[:, i, 2, None] * v[2] for i in range(3)]
        if tc is not None:
            out = [out[i] + tc[:, i, None] for i in range(3)]
        return out

    ps, ns = pose(0, R[s], tr[s]), pose(3, R[s], None)
    pt, nt = pose(6, R[tg], tr[tg]), pose(9, R[tg], None)
    dx, dy, dz = pt[0] - ps[0], pt[1] - ps[1], pt[2] - ps[2]
    r1 = ns[0] * dx + ns[1] * dy + ns[2] * dz
    r2 = -(nt[0] * dx + nt[1] * dy + nt[2] * dz)
    return ps, ns, pt, nt, r1, r2, d[12]


def _chunk_costs_plain(r1, r2, w):
    return torch.sum(w * (r1 * r1 + r2 * r2), -1).double()


def _pair_sums_plain(q, t, data, chunk_pairs, chunk: int):
    """Per-chunk sums ``A (G,6,6)``, ``g (G,6)``, ``c (G,)`` in float64 (the
    quantities the kernel reduces; see ``csrc/gn_fused.cu``), computed in
    ``data.dtype`` within a chunk."""
    (psx, psy, psz), (nsx, nsy, nsz), (ptx, pty, ptz), (ntx, nty, ntz), r1, r2, w = _posed_plain(
        q, t, data, chunk_pairs, chunk)
    j1 = torch.stack([nsx, nsy, nsz, pty * nsz - ptz * nsy,
                      ptz * nsx - ptx * nsz, ptx * nsy - pty * nsx])  # (6,G,chunk)
    j2 = torch.stack([ntx, nty, ntz, psy * ntz - psz * nty,
                      psz * ntx - psx * ntz, psx * nty - psy * ntx])
    A = (torch.einsum("agc,bgc->gab", j1 * w, j1)
         + torch.einsum("agc,bgc->gab", j2 * w, j2))
    g = torch.einsum("agc,gc->ga", j1, w * r1) - torch.einsum("agc,gc->ga", j2, w * r2)
    return A.double(), g.double(), _chunk_costs_plain(r1, r2, w)


def gn_fused_plain(q, t, data, chunk_pairs, num_clouds: int, chunk: int):
    """Plain PyTorch version of the B1 kernel: H (6C,6C), b (6C,), cost, all
    float64 tensors on ``data``'s device. ``data.dtype`` float64 gives the
    float64 reference."""
    A, g, c = _pair_sums_plain(q, t, data, chunk_pairs, chunk)
    C = num_clouds
    s, tg = chunk_pairs[:, 0].long(), chunk_pairs[:, 1].long()
    eye = torch.eye(C, dtype=torch.float64, device=data.device)
    e = eye[tg] - eye[s]  # (G,C): +1 on the target cloud, -1 on the source
    H = torch.einsum("gc,gd,gab->cadb", e, e, A).reshape(6 * C, 6 * C)
    b = torch.einsum("gc,ga->ca", e, g).reshape(6 * C)
    return H, b, c.sum()


def gn_cost_batch_plain(qs, ts, data, chunk_pairs, num_clouds: int, chunk: int):
    """Plain PyTorch version of B1's cost-batch mode: the stack of
    ``gn_fused_plain(qs[k], ts[k], ...)[2]``, ``(K,)`` float64."""
    return torch.stack([_chunk_costs_plain(*_posed_plain(qs[k], ts[k], data, chunk_pairs, chunk)[4:]).sum()
                        for k in range(qs.shape[0])])


def _check_fused(poses, data, chunk_pairs, chunk: int):
    """The checks shared by B1's two wrappers; ``poses`` are ``(name, tensor,
    shape)``."""
    G = _check_packed(data, chunk)
    if data.device.type != "meta" and data.data_ptr() % 16 != 0:
        raise ValueError("packed data must start at a 16-byte boundary (an offset view need "
                         "not): the kernel reads four columns per load")
    if tuple(chunk_pairs.shape) != (G, 2) or chunk_pairs.dtype != torch.int32:
        raise ValueError(f"chunk_pairs must be int32 ({G}, 2); got "
                         f"{chunk_pairs.dtype} {tuple(chunk_pairs.shape)}")
    for name, x, shape in poses:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(x.shape)}")
    for x in (*[x for _, x, _ in poses], chunk_pairs):
        if x.device != data.device:
            raise ValueError(f"all inputs must be on {data.device}; got {x.device}")


def _fused_launch_args(data, num_clouds: int, chunk: int, record_floats: int):
    """What B1's two launches share on the card: the kernel's limits (clouds
    held in shared memory, columns per unit), the persistent grid and the
    scratch kept between calls."""
    from dataset_pipeline_tpu_torch import kernels

    if num_clouds > _GN_MAX_CLOUDS:
        raise ValueError(f"num_clouds={num_clouds} > {_GN_MAX_CLOUDS}: the kernel holds every "
                         "cloud's pose in shared memory")
    if chunk % _GN_UNIT != 0:
        raise ValueError(f"chunk={chunk} must be a multiple of {_GN_UNIT} on CUDA")
    lib = kernels.library()
    stream = torch.cuda.current_stream(data.device).cuda_stream
    nblocks = kernels.persistent_grid("dpt_gn_grid", data.device)
    slots = nblocks + data.shape[1] // chunk
    records, tags, ticket = kernels.scratch("gn_fused", data.device, stream,
                                            slots * record_floats, 2 * slots)
    return lib, stream, nblocks, records, tags, ticket


def _f32c(x):
    return x if x.dtype == torch.float32 and x.is_contiguous() else x.to(torch.float32).contiguous()


def icp_hb_cost_fused(q, t, data, chunk_pairs, num_clouds: int, chunk: int):
    """H (6C,6C), b (6C,), cost (float64 tensors) of the symmetric
    point-to-plane residuals at per-cloud corrections ``q (C,4)`` wxyz,
    ``t (C,3)``; ``chunk_pairs (Mp//chunk, 2)`` int32 holds each chunk's
    (source, target) cloud ids.

    Counterpart of ``icp_hb_cost_pallas_fused``, with per-chunk instead of
    per-row cloud ids: the engine packs one pair per chunk, so a constant
    pair per chunk holds by construction.
    """
    C = num_clouds
    _check_fused((("q", q, (C, 4)), ("t", t, (C, 3))), data, chunk_pairs, chunk)
    if data.device.type == "cpu":
        return gn_fused_plain(q, t, data, chunk_pairs, C, chunk)

    from dataset_pipeline_tpu_torch import kernels

    lib, stream, nblocks, records, tags, _ = _fused_launch_args(data, C, chunk, 28)
    q, t, pairs = _f32c(q), _f32c(t), chunk_pairs.contiguous()
    out = torch.empty((6 * C + 1, 6 * C + 1), dtype=torch.float64, device=data.device)
    err = lib.dpt_gn_fused(
        data.data_ptr(), data.shape[0], data.shape[1], pairs.data_ptr(), q.data_ptr(),
        t.data_ptr(), C, chunk, nblocks, records.data_ptr(), tags.data_ptr(), out.data_ptr(),
        stream)
    kernels.check(err, "dpt_gn_fused")
    LAUNCHES["gn_fused"] += 1
    n = 6 * C
    return out[:n, :n], out[:n, n], out[n, n]


def icp_cost_batch_fused(qs, ts, data, chunk_pairs, num_clouds: int, chunk: int):
    """The cost alone under ``K <= 10`` candidate corrections ``qs (K,C,4)``,
    ``ts (K,C,3)`` in one pass over the packed tensor: ``(K,)`` float64, element
    ``k`` being ``icp_hb_cost_fused(qs[k], ts[k], ...)[2]`` (with its bits on
    the card). It is what the LM ladder needs of its candidates.

    Counterpart of the JAX engine's ``cost_batch`` (``_icp_cost_batch`` on
    the CPU, K launches of the fused kernel on the TPU).
    """
    C = num_clouds
    K = qs.shape[0] if qs.dim() == 3 else -1
    if not 1 <= K <= GN_MAX_CANDIDATES:
        raise ValueError(f"qs must be (K, {C}, 4) with 1 <= K <= {GN_MAX_CANDIDATES}; got "
                         f"{tuple(qs.shape)}")
    _check_fused((("qs", qs, (K, C, 4)), ("ts", ts, (K, C, 3))), data, chunk_pairs, chunk)
    if data.device.type == "cpu":
        return gn_cost_batch_plain(qs, ts, data, chunk_pairs, C, chunk)

    from dataset_pipeline_tpu_torch import kernels

    lib, stream, nblocks, records, tags, ticket = _fused_launch_args(
        data, C, chunk, GN_MAX_CANDIDATES)
    qs, ts, pairs = _f32c(qs), _f32c(ts), chunk_pairs.contiguous()
    out = torch.empty(K, dtype=torch.float64, device=data.device)
    err = lib.dpt_gn_cost_batch(
        data.data_ptr(), data.shape[0], data.shape[1], pairs.data_ptr(), qs.data_ptr(),
        ts.data_ptr(), K, C, chunk, nblocks, records.data_ptr(), tags.data_ptr(),
        ticket.data_ptr(), out.data_ptr(), stream)
    kernels.check(err, "dpt_gn_cost_batch")
    LAUNCHES["gn_fused_cost_batch"] += 1
    return out


# ---------------------------------------------------------------------------
# B2: monomial moment Gram
# ---------------------------------------------------------------------------


def monomials_packed(data):
    """(42, Mp) monomials of packed columns: ``[b; a_k * b]`` with
    ``b = sqrt(w) [ns; nt]``, ``a = (ps_0, ps_1, ps_2, pt_0, pt_1, pt_2)``."""
    b = torch.cat([data[3:6], data[9:12]]) * torch.sqrt(data[12:13])
    return torch.cat([b] + [data[i:i + 1] * b for i in (0, 1, 2, 6, 7, 8)])


def moment_gram_plain(data, chunk: int):
    """Plain PyTorch version of the B2 kernel: per-chunk Grams
    ``(Mp//chunk, 42, 42)`` in ``data.dtype``."""
    m = monomials_packed(data).reshape(N_MONO, -1, chunk)
    return torch.einsum("agc,bgc->gab", m, m)


def moment_gram_partials(data, chunk: int):
    """Partial monomial Grams of the packed tensor: ``(parts (n, 42, 42)
    float32, parts_per_chunk)``. Every part lies inside one chunk and part
    ``i`` belongs to chunk ``i // parts_per_chunk``; the caller sums a
    group's parts in float64.

    Counterpart of ``icp_moment_pallas_tri_sub`` + ``moment_tri_extract``.
    """
    _check_packed(data, chunk)
    if data.device.type == "cpu":
        return moment_gram_plain(data, chunk), 1

    from dataset_pipeline_tpu_torch import kernels

    lib = kernels.library()
    Mp = data.shape[1]
    rows_per_block = _moment_rows_per_block(chunk, Mp, data.device)
    nblocks = Mp // rows_per_block
    parts = torch.empty((nblocks, N_MONO, N_MONO), dtype=torch.float32, device=data.device)
    err = lib.dpt_moment_gram(
        data.data_ptr(), data.shape[0], Mp, rows_per_block, parts.data_ptr(),
        nblocks, torch.cuda.current_stream(data.device).cuda_stream)
    kernels.check(err, "dpt_moment_gram")
    LAUNCHES["moment_gram"] += 1
    return parts, chunk // rows_per_block


def _moment_rows_per_block(chunk: int, Mp: int, device) -> int:
    """Rows per block of the B2 kernel: a multiple of its 256-row tile that
    divides ``chunk`` (a part lies inside one chunk), at most 16384 and at
    least 4096 where the chunk has such a divisor, taking the fewest rows
    per resident block over the whole launch (waves x rows per block, the
    resident slots as the runtime reports them), the largest among equals.
    At 8.06 M rows, chunk 49152, on 132 slots: 12288 rows, 5.0 waves, where
    8192 rows take 7.5 waves, so 8."""
    from dataset_pipeline_tpu_torch import kernels

    if chunk % _MOMENT_TILE != 0:
        raise ValueError(f"chunk={chunk} must be a multiple of {_MOMENT_TILE} on CUDA")
    slots = kernels.persistent_grid("dpt_moment_gram_grid", device)
    options = [r for r in range(_MOMENT_TILE, min(chunk, _MOMENT_MAX_ROWS) + 1, _MOMENT_TILE)
               if chunk % r == 0]
    options = [r for r in options if r >= min(chunk, _MOMENT_MIN_ROWS)] or options

    def rows_per_slot(r):
        waves = -(-(Mp // r) // slots)
        return waves * r, -r

    return min(options, key=rows_per_slot)


# ---------------------------------------------------------------------------
# B4b, B4c: the earlier generations of the moment Gram
# ---------------------------------------------------------------------------


def moment_gram48_plain(data, chunk: int):
    """Plain PyTorch version of the B4b kernel: ``(Mp//chunk, 48, 48)`` in
    ``data.dtype``, rows and columns 42..47 zero."""
    return torch.nn.functional.pad(moment_gram_plain(data, chunk), (0, 6, 0, 6))


def moment_gram48(data, chunk: int = 16384):
    """Per-chunk monomial Grams ``(Mp//chunk, 48, 48)`` float32 of the packed
    tensor, one part per chunk, zero-padded from 42 as the JAX output is.

    Counterpart of ``icp_moment_pallas``.
    """
    G = _check_packed(data, chunk)
    if data.device.type == "cpu":
        return moment_gram48_plain(data, chunk)

    from dataset_pipeline_tpu_torch import kernels

    parts = torch.empty((G, 48, 48), dtype=torch.float32, device=data.device)
    err = kernels.library().dpt_moment_gram48(
        data.data_ptr(), data.shape[0], data.shape[1], chunk, parts.data_ptr(), G,
        torch.cuda.current_stream(data.device).cuda_stream)
    kernels.check(err, "dpt_moment_gram48")
    LAUNCHES["moment_gram48"] += 1
    return parts


def moment_gram_thirds_plain(data, chunk: int):
    """Plain PyTorch version of the B4c kernel: ``(Mp//chunk, 3, 42, 42)`` in
    ``data.dtype``, the Gram of each column-third of each chunk."""
    return moment_gram_plain(data, chunk // 3).reshape(-1, 3, N_MONO, N_MONO)


def moment_gram_thirds(data, chunk: int = 24576):
    """Per chunk of the packed tensor, the monomial Grams of its three
    column-thirds: ``(Mp//chunk, 3, 42, 42)`` float32; ``chunk`` must be a
    multiple of 3. :func:`moment_tri_extract` sums them into the chunk's Gram.

    Counterpart of ``icp_moment_pallas_tri``, whose ``(128, 128)`` output per
    chunk carries these three Grams on its diagonal blocks; the off-diagonal
    blocks, which its callers discard, are not computed.
    """
    G = _check_packed(data, chunk)
    if chunk % 3 != 0:
        raise ValueError(f"chunk={chunk} must be a multiple of 3")
    if data.device.type == "cpu":
        return moment_gram_thirds_plain(data, chunk)

    from dataset_pipeline_tpu_torch import kernels

    parts = torch.empty((G, 3, N_MONO, N_MONO), dtype=torch.float32, device=data.device)
    err = kernels.library().dpt_moment_gram_thirds(
        data.data_ptr(), data.shape[0], data.shape[1], chunk, parts.data_ptr(), G,
        torch.cuda.current_stream(data.device).cuda_stream)
    kernels.check(err, "dpt_moment_gram_thirds")
    LAUNCHES["moment_gram_thirds"] += 1
    return parts


def moment_tri_extract(parts):
    """``(grid, 3, 42, 42)`` per-third Grams -> ``(grid, 42, 42)`` chunk Grams
    (tensor or numpy array)."""
    return parts[:, 0] + parts[:, 1] + parts[:, 2]


# ---------------------------------------------------------------------------
# B5a: the moment Gram over a repeat axis (timing harness)
# ---------------------------------------------------------------------------


def moment_gram_repeat_plain(data2, chunk: int, repeats: int):
    """Plain PyTorch version of the B5a kernel: repeat ``r`` adds the Grams of
    copy ``r % 2``, in ``data2.dtype``."""
    n0, n1 = (repeats + 1) // 2, repeats // 2
    out = n0 * moment_gram_plain(data2[0], chunk)
    return out + n1 * moment_gram_plain(data2[1], chunk) if n1 else out


def moment_gram_repeat(data2, chunk: int = 49152, repeats: int = 1):
    """``(parts (n, 42, 42) float32, parts_per_chunk)`` with
    ``parts = sum_r Gram(data2[r % 2])`` over ``repeats`` passes, partitioned
    as :func:`moment_gram_partials` does; ``data2`` is ``(2, rows, Mp)``.

    Every repeat sweeps one whole copy from device memory, so
    ``(T(repeats=R) - T(repeats=1)) / (R - 1)`` is the time of one moment
    pass without launch or host overhead. Counterpart of
    ``icp_moment_pallas_tri_sub_timed``.
    """
    if data2.dim() != 3 or data2.shape[0] != 2:
        raise ValueError(f"data2 must be (2, rows, Mp); got {tuple(data2.shape)}")
    if not data2.is_contiguous():
        raise ValueError("data2 must be contiguous")
    if repeats < 1:
        raise ValueError(f"repeats={repeats} must be >= 1")
    _check_packed(data2[0], chunk)
    if data2.device.type == "cpu":
        return moment_gram_repeat_plain(data2, chunk, repeats), 1

    from dataset_pipeline_tpu_torch import kernels

    Mp = data2.shape[2]
    rows_per_block = _moment_rows_per_block(chunk, Mp, data2.device)
    nblocks = Mp // rows_per_block
    parts = torch.empty((nblocks, N_MONO, N_MONO), dtype=torch.float32, device=data2.device)
    err = kernels.library().dpt_moment_gram_repeat(
        data2.data_ptr(), data2.shape[1], Mp, rows_per_block, parts.data_ptr(), nblocks,
        repeats, torch.cuda.current_stream(data2.device).cuda_stream)
    kernels.check(err, "dpt_moment_gram_repeat")
    LAUNCHES["moment_gram_repeat"] += 1
    return parts, chunk // rows_per_block


# ---------------------------------------------------------------------------
# B4a: H, b, cost from precomputed rows with per-row cloud ids
# ---------------------------------------------------------------------------


def gn_rows_prep(q, t, ps, ns, pt, nt, sid, tid):
    """The elementwise pass before the B4a kernel (plain PyTorch on both
    sides, as it is XLA in the JAX package): global-frame Jacobian vectors
    ``j1 = [n_s; p_t x n_s]``, ``j2 = [n_t; p_s x n_t]`` as ``(6, M)`` and
    residuals ``r1, r2 (M,)`` of ``(M, 3)`` correspondences. An id outside
    ``[0, C)`` takes the pose that JAX's gather gives it: a negative id counts
    from the end, then the id is clamped into range."""
    C = q.shape[0]
    sid, tid = (torch.where(i < 0, i + C, i).clamp(0, C - 1) for i in (sid.long(), tid.long()))
    gps = quat_rotate(q[sid], ps) + t[sid]
    gns = quat_rotate(q[sid], ns)
    gpt = quat_rotate(q[tid], pt) + t[tid]
    gnt = quat_rotate(q[tid], nt)
    diff = gpt - gps
    r1 = torch.sum(gns * diff, -1)
    r2 = -torch.sum(gnt * diff, -1)
    j1 = torch.cat([gns, torch.linalg.cross(gpt, gns, dim=-1)], -1).T.contiguous()
    j2 = torch.cat([gnt, torch.linalg.cross(gps, gnt, dim=-1)], -1).T.contiguous()
    return j1, j2, r1, r2


def gn_rows_plain(j1, j2, r1, r2, sid, tid, w, num_clouds: int):
    """Plain PyTorch version of the B4a kernel: H (6C,6C), b (6C,), cost as
    float64 tensors; the products run in ``j1.dtype`` per 65536 columns and
    are added in float64."""
    C = num_clouds
    n = 6 * C
    G = torch.zeros((n + 1, n + 1), dtype=torch.float64, device=j1.device)
    clouds = torch.arange(C, device=j1.device)[:, None]
    for s in range(0, j1.shape[1], _ROWS_PLAIN_CHUNK):
        sl = slice(s, s + _ROWS_PLAIN_CHUNK)
        s1 = ((tid[sl][None] == clouds).to(j1.dtype) - (sid[sl][None] == clouds).to(j1.dtype))
        sw = torch.sqrt(w[sl])
        A1 = torch.cat([(s1[:, None] * j1[None, :, sl]).reshape(n, -1), r1[None, sl]]) * sw
        A2 = torch.cat([(-s1[:, None] * j2[None, :, sl]).reshape(n, -1), r2[None, sl]]) * sw
        G += (A1 @ A1.T + A2 @ A2.T).double()
    return G[:n, :n], G[:n, n], G[n, n]


def gn_rows(j1, j2, r1, r2, sid, tid, w, num_clouds: int):
    """H (6C,6C), b (6C,), cost (float64 tensors) from precomputed rows:
    ``j1, j2 (6, M)`` and ``r1, r2, w (M,)`` float32, ``sid, tid (M,)`` int32
    cloud ids that may change from row to row; ``w >= 0`` (the JAX kernel
    takes its square root). As in the JAX kernel's one-hot rule an id outside
    ``[0, C)`` matches no cloud: a row whose two ids are equal, or both
    outside, adds to the cost only; a row with one id outside adds to H and b
    at the other id's block."""
    M = j1.shape[1] if j1.dim() == 2 else -1
    C = num_clouds
    for name, x, shape, dtype in (("j1", j1, (6, M), torch.float32), ("j2", j2, (6, M), torch.float32),
                                  ("r1", r1, (M,), torch.float32), ("r2", r2, (M,), torch.float32),
                                  ("w", w, (M,), torch.float32), ("sid", sid, (M,), torch.int32),
                                  ("tid", tid, (M,), torch.int32)):
        if M <= 0 or tuple(x.shape) != shape or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} {shape}; got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != j1.device:
            raise ValueError(f"all inputs must be on {j1.device}; got {x.device}")
    if C < 1:
        raise ValueError(f"num_clouds={C} must be >= 1")
    if j1.device.type == "cpu":
        return gn_rows_plain(j1, j2, r1, r2, sid, tid, w, C)
    if j1.device.type != "cuda":
        raise ValueError(f"unsupported device {j1.device}")
    if C > _ROWS_MAX_CLOUDS:
        raise ValueError(f"num_clouds={C} > {_ROWS_MAX_CLOUDS}: the kernel's per-warp class "
                         "tables would exceed a block's shared memory")

    from dataset_pipeline_tpu_torch import kernels

    lib = kernels.library()
    stream = torch.cuda.current_stream(j1.device).cuda_stream
    nblocks = kernels.persistent_grid("dpt_gn_rows_grid", j1.device, C)
    sums = C * (C + 1) // 2 * _ROWS_SUMS  # per block: a record per class
    scratch, _, ticket = kernels.scratch("gn_rows", j1.device, stream, (nblocks + 2) * sums, 1)
    S = 6 * C + 1
    out = torch.empty((S, S), dtype=torch.float64, device=j1.device)
    err = lib.dpt_gn_rows(
        j1.data_ptr(), j2.data_ptr(), r1.data_ptr(), r2.data_ptr(), sid.data_ptr(),
        tid.data_ptr(), w.data_ptr(), M, C, nblocks,
        scratch.data_ptr(), ticket.data_ptr(), out.data_ptr(), stream)
    kernels.check(err, "dpt_gn_rows")
    LAUNCHES["gn_rows"] += 1
    n = 6 * C
    return out[:n, :n], out[:n, n], out[n, n]


def icp_hb_cost_rows(q, t, ps, ns, pt, nt, sid, tid, w, num_clouds: int):
    """H, b, cost (float64 tensors) of ``(M, 3)`` global-frame
    correspondences with per-row cloud ids at corrections ``q (C,4)``,
    ``t (C,3)``: the plain prep pass, then the B4a kernel.

    Counterpart of ``icp_hb_cost_pallas`` with the same argument order; it
    has no ``chunk``, since the kernel masks its ragged last block and
    nothing is padded.
    """
    j1, j2, r1, r2 = gn_rows_prep(q, t, ps, ns, pt, nt, sid, tid)
    return gn_rows(j1, j2, r1, r2, sid.to(torch.int32).contiguous(),
                   tid.to(torch.int32).contiguous(), w.contiguous(), num_clouds)
