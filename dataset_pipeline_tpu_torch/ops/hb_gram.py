"""The hand-written kernel ``csrc/hb_gram.cu`` for the residuals and Gram
products of the registrator's H,b accumulation
(``photometric/optimizer.py:_gram_assemble``).

From J (nb, M, V), the rows' intensities and validity, the neighbour lists
and descriptors ((M, K) shared by the chunk's images, or (nb, M, K) per
image, as the observation cache's views hold them) and the contribution mask,
:func:`gram_assemble` returns what ``_gram_assemble`` returns: H (nb, V, V),
b (nb, V), the summed Huber cost and the residual count. Rows that make no
residual read no J. The sums are deterministic: the same inputs give the
same bits.

``_hb_batch`` and ``_hb_rig_batch`` launch the kernel wherever J is on the
card (:func:`uses_kernel`) and take the plain ``_gram_assemble`` for CPU
tensors alone; on the card the wrapper takes float32 J up to
:data:`MAX_V` wide, every width the registrator produces, and raises for
anything else. Joint BA calls the plain version itself, in float64.
:func:`oracle` and :func:`gaps` hold the kernel to the plain version.
``kernels.LAUNCHES["hb_gram"]`` counts the calls that launched it.
"""

from __future__ import annotations

import torch

from dataset_pipeline_tpu_torch import kernels
from dataset_pipeline_tpu_torch.ops.robust import DEFAULT_COLOR_HUBER

MAX_V = 24  # a rig's 6 + 6 pose dofs under a model of 12 intrinsics


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
    """(H (nb,V,V), b (nb,V), cost, count) of ``_gram_assemble`` by the
    kernel; cost a float32 and count an int64 scalar tensor, all on the card,
    nothing synchronised."""
    if not (uses_kernel(J) and J.dtype == torch.float32 and 1 <= J.shape[-1] <= MAX_V):
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
    """The plain ``_gram_assemble`` with J in float64, image by image (so
    that no temporary holds more than one image's rows): (H, b, cost, count)
    in float64, count an int."""
    from dataset_pipeline_tpu_torch.photometric.optimizer import _gram_assemble

    contrib = torch.broadcast_to(contrib, ok.shape)
    parts = []
    for i in range(J.shape[0]):
        one = [x[i:i + 1] if x.dim() == 3 else x for x in (neighbors, desc)]
        parts.append(_gram_assemble(J[i:i + 1].double(), inten[i:i + 1], ok[i:i + 1], *one,
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
