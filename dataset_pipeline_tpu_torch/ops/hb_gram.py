"""The residuals and Gram products of the registrator's H,b accumulation:
the plain version and the hand-written kernel ``csrc/hb_gram.cu``.

From J (nb, M, V), the rows' intensities and validity, the neighbour lists
and descriptors ((M, K) shared by the chunk's images, or (nb, M, K) per
image, as the observation cache's views hold them) and the contribution mask,
:func:`gram_assemble` returns H (nb, V, V), b (nb, V), the summed Huber cost
and the residual count. It takes the kernel wherever J is on the card
(:func:`uses_kernel`) and the plain :func:`gram_assemble_plain` for CPU
tensors; on the card the kernel takes float32 J up to :data:`MAX_V` wide,
every width the registrator produces, and raises for anything else, so that
nothing on the card falls back. In the kernel rows that make no residual
read no J, and the sums are deterministic: the same inputs give the same
bits. Joint BA calls the plain version itself, in float64.
:func:`oracle` and :func:`gaps` hold the kernel to the plain version.
``kernels.LAUNCHES["hb_gram"]`` counts the calls that launched it.

The descriptor residual of a point is the vector over its K neighbours of
I(neighbour) - I(centre) - descriptor, Huber-weighted on its norm
(:func:`descriptor_residuals`, :func:`huber_terms`); the registrator's costs
and descriptors and joint BA's share these definitions.
"""

from __future__ import annotations

import torch

from dataset_pipeline_tpu_torch import kernels
from dataset_pipeline_tpu_torch.ops.robust import DEFAULT_COLOR_HUBER, huber_rho, huber_weight

MAX_V = 24  # a rig's 6 + 6 pose dofs under a model of 12 intrinsics
_INVALID_INTENSITY = 3.0e8  # neighbor-validity sentinel, exact in float32
_GRAM_ROWS = 8192  # rows per batch entry of the split Gram products


def gram(x, y):
    """Per-image x^T y: (nb,M,a), (nb,M,b) -> (nb,a,b) in strict fp32.

    The row axis is cut into slices of ``_GRAM_ROWS`` that become separate
    batch entries, summed afterwards: one (a x M)(M x b) product per image
    with M ~ 10^6 and a, b <= 10 leaves cuBLAS a handful of output tiles, so
    it ran on a few SMs (~18 ms per product on the H100, 75 % of the
    registrator's device time). Operands of two float dtypes meet in the
    wider one."""
    if x.dtype != y.dtype:
        dt = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(dt), y.to(dt)
    nb, M, a = x.shape
    S = M // _GRAM_ROWS
    n = S * _GRAM_ROWS
    out = None
    if S:
        out = torch.bmm(x[:, :n].reshape(nb * S, _GRAM_ROWS, a).transpose(1, 2),
                        y[:, :n].reshape(nb * S, _GRAM_ROWS, y.shape[-1])
                        ).view(nb, S, a, -1).sum(1)
    if n < M:
        rest = torch.bmm(x[:, n:].transpose(1, 2), y[:, n:])
        out = rest if out is None else out + rest
    return out


def _rows(x, idx, per_image: bool):
    """Rows of ``x`` (nb, M, ...) picked by ``idx``: one index array for
    every image (M', ...), or ``per_image`` (nb, M', ...); -> (nb, M', ...)."""
    if not per_image:
        return x[:, idx]
    ar = torch.arange(x.shape[0], device=x.device).view((-1,) + (1,) * (idx.dim() - 1))
    return x[ar, idx]


def nbr_inten_ok(inten, ok, neighbors):
    """Neighbor (intensity, validity) in one gather: validity rides as the
    3e8 sentinel inside the intensity plane (intensities live in [0, 255]).
    ``inten``/``ok`` (nb,M), ``neighbors`` (M,K) or per image (nb,M,K) ->
    (nb,M,K) each."""
    enc = torch.where(ok, inten, torch.full_like(inten, _INVALID_INTENSITY))
    ge = _rows(enc, neighbors, neighbors.dim() == 3)
    nbr_ok = ge < 1.5e8
    return torch.where(nbr_ok, ge, torch.zeros_like(ge)), nbr_ok


def descriptor_residuals(inten, ok, neighbors, desc, contrib):
    """(r (nb,M,K), all_ok (nb,M)): a point makes a residual iff it and all
    its K neighbours are valid and it contributes; component k is
    I(neighbour_k) - I(centre) - desc_k, zero where the point makes none.
    ``desc`` None gives the image-space descriptors I(neighbour_k) -
    I(centre) themselves."""
    nbr_inten, nbr_ok = nbr_inten_ok(inten, ok, neighbors)
    all_ok = ok & torch.all(nbr_ok, -1) & contrib
    r = nbr_inten - inten[..., None]
    if desc is not None:
        r = r - desc
    return torch.where(all_ok[..., None], r, torch.zeros_like(r)), all_ok


def huber_terms(r):
    """(norm, rho) of residual vectors ``r`` (..., K): the component-vector
    norm and its Huber cost."""
    norm = torch.sqrt(torch.clamp(torch.sum(r * r, -1), min=1e-20))
    return norm, huber_rho(norm, DEFAULT_COLOR_HUBER)


def gram_assemble_plain(J, inten, ok, neighbors, desc, contrib_mask):
    """H (nb,V,V), b (nb,V), cost, count from the per-point intensity
    Jacobian J (nb,M,V).

    The residual rows r_nk = I[nbr_nk] - I[n] - d_nk have Jacobian
    J[nbr_nk] - J[n]; the Gram sum is expanded per neighbor slot k with
    A_k = J[nbr_:,k] (one gather each, then strict-fp32 batched products,
    :func:`gram`):

      H = sum_k [A_k^T W A_k - A_k^T W J - (A_k^T W J)^T] + K J^T W J
      b = sum_k A_k^T (w r_k)  -  J^T (w sum_k r_k)
    """
    r, all_ok = descriptor_residuals(inten, ok, neighbors, desc, contrib_mask)
    norm, rho = huber_terms(r)
    w = torch.where(all_ok, huber_weight(norm, DEFAULT_COLOR_HUBER), torch.zeros_like(norm))
    # invalid points carry no weight but may hold non-finite J entries
    J = torch.where(ok[..., None], J, torch.zeros_like(J))
    K = neighbors.shape[-1]
    H = K * gram(w[..., None] * J, J)
    b = -gram(J, (w * torch.sum(r, -1))[..., None])[..., 0]
    for k in range(K):
        Ak = _rows(J, neighbors[..., k], neighbors.dim() == 3)
        WAk = w[..., None] * Ak
        M = gram(WAk, J)
        H = H + gram(WAk, Ak) - M - M.transpose(1, 2)
        b = b + gram(Ak, (w * r[..., k])[..., None])[..., 0]
    cost = torch.sum(torch.sum(torch.where(all_ok, rho, torch.zeros_like(rho)), 1))
    return H, b, cost, torch.sum(all_ok)


def inverse_depths(D, z):
    """(1/D or 0 where D <= 0, 1/z or 0 where z == 0, z with 0 -> 1)."""
    inv_D = torch.where(D > 0, 1.0 / torch.clamp(D, min=1e-9), torch.zeros_like(D))
    safe_z = torch.where(z == 0, torch.ones_like(z), z)
    inv_z = torch.where(z != 0, 1.0 / safe_z, torch.zeros_like(z))
    return inv_D, inv_z, safe_z


def uses_kernel(J) -> bool:
    """Whether the kernel takes these Jacobian rows: any on the card (where
    :func:`gram_assemble` refuses what it cannot take), none on the CPU."""
    return J.device.type == "cuda"


def _blocks_per_image(V: int, nb: int, M: int, device) -> int:
    """One full wave of the kernel dealt among the images, at most one
    block per tile of 256 rows."""
    wave = kernels.persistent_grid("dpt_hb_gram_grid", device, V)
    tiles = max(1, -(-M // 256))
    return max(1, min(tiles, -(-wave // nb), 65535))


def gram_assemble(J, inten, ok, neighbors, desc, contrib):
    """(H (nb,V,V), b (nb,V), cost, count) of :func:`gram_assemble_plain`:
    for CPU tensors by the plain version; on the card by the kernel, cost a
    float32 and count an int64 scalar tensor, all on the card, nothing
    synchronised."""
    if not uses_kernel(J):
        return gram_assemble_plain(J, inten, ok, neighbors, desc, contrib)
    if not (J.dtype == torch.float32 and 1 <= J.shape[-1] <= MAX_V):
        raise ValueError(f"the kernel takes float32 J on the card, at most {MAX_V} wide; got "
                         f"{J.dtype} {tuple(J.shape)} on {J.device}")
    nb, M, V = J.shape
    K = neighbors.shape[-1]
    dev = J.device
    nbr_per_image, desc_per_image = neighbors.dim() == 3, desc.dim() == 3
    if (tuple(inten.shape) != (nb, M) or tuple(ok.shape) != (nb, M)
            or tuple(neighbors.shape) != ((nb, M, K) if nbr_per_image else (M, K))
            or tuple(desc.shape) != ((nb, M, K) if desc_per_image else (M, K))):
        raise ValueError(f"inten and ok ({nb}, {M}), neighbours and desc ({M}, K) or "
                         f"({nb}, {M}, K); got {tuple(inten.shape)}, {tuple(ok.shape)}, "
                         f"{tuple(neighbors.shape)}, {tuple(desc.shape)}")
    contrib = torch.broadcast_to(contrib, (nb, M))
    args = [x.contiguous() for x in (J, inten, ok, neighbors, desc, contrib)]
    for x, dt in zip(args, (torch.float32, torch.float32, torch.bool, torch.int64, torch.float32,
                            torch.bool)):
        if x.dtype != dt or x.device != dev:
            raise ValueError(f"expected {dt} on {dev}; got {x.dtype} on {x.device}")
    G = _blocks_per_image(V, nb, M, dev)
    lib = kernels.library()
    partial = torch.empty(nb * G * lib.dpt_hb_gram_record(V), dtype=torch.float64, device=dev)
    out = torch.empty(nb * V * V + nb * V + 1, dtype=torch.float32, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    err = lib.dpt_hb_gram(
        args[0].data_ptr(), V, args[1].data_ptr(), args[2].data_ptr(), args[3].data_ptr(),
        int(nbr_per_image), args[4].data_ptr(), int(desc_per_image), args[5].data_ptr(), M, nb,
        K, G, DEFAULT_COLOR_HUBER, 0.5 * DEFAULT_COLOR_HUBER, partial.data_ptr(), out.data_ptr(),
        out[nb * V * V:].data_ptr(), out[-1:].data_ptr(), count.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "dpt_hb_gram")
    kernels.LAUNCHES["hb_gram"] += 1
    return (out[:nb * V * V].view(nb, V, V), out[nb * V * V:nb * V * (V + 1)].view(nb, V),
            out[-1], count)


def oracle(J, inten, ok, neighbors, desc, contrib):
    """:func:`gram_assemble_plain` with J in float64, image by image (so
    that no temporary holds more than one image's rows): (H, b, cost, count)
    in float64, count an int."""
    contrib = torch.broadcast_to(contrib, ok.shape)
    parts = []
    for i in range(J.shape[0]):
        one = [x[i:i + 1] if x.dim() == 3 else x for x in (neighbors, desc)]
        parts.append(gram_assemble_plain(J[i:i + 1].double(), inten[i:i + 1], ok[i:i + 1], *one,
                                         contrib[i:i + 1]))
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
            sum(float(p[2]) for p in parts), sum(int(p[3]) for p in parts))


def gaps(out, ref):
    """(H_gap, b_gap, cost_gap) of ``out`` against ``ref`` (H, b, cost,
    count): max |dH_ij| / sqrt(H_ii H_jj); max |db_i| / sqrt(H_ii) over the
    largest |b_i| / sqrt(H_ii); the cost's relative gap. An entry whose scale
    is 0 (an image without residuals) counts 0 if it is 0 too, else inf."""
    H, b = out[0].double(), out[1].double()
    Hr, br = ref[0].double().to(H.device), ref[1].double().to(H.device)
    cost, cr = float(out[2]), float(ref[2])

    def ratio(num, den):
        return torch.where(num == 0, torch.zeros_like(num), num / den)

    d = torch.diagonal(Hr, dim1=1, dim2=2)
    H_gap = float(ratio((H - Hr).abs(), torch.sqrt(d[:, :, None] * d[:, None, :])).max())
    b_err = ratio((b - br).abs(), torch.sqrt(d)).max()
    b_gap = float(ratio(b_err, ratio(br.abs(), torch.sqrt(d)).max()))
    cost_gap = 0.0 if cost == cr else abs(cost - cr) / abs(cr) if cr else float("inf")
    return H_gap, b_gap, cost_gap
