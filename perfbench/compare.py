"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the plain reference computes from the same inputs. Every
number is 0 for identical outputs and grows with the disagreement."""

from __future__ import annotations

import torch


def depth_bad_share(prog, ref, tol_m: float) -> float:
    """Share of pixels where exactly one map is finite, or both are and
    differ by more than ``tol_m``."""
    prog, ref = torch.as_tensor(prog).to(ref.device).double(), ref.double()
    fp, fr = torch.isfinite(prog), torch.isfinite(ref)
    bad = (fp != fr) | (fp & fr & ((prog - ref).abs() > tol_m))
    return float(bad.double().mean())


def mismatch_share(prog, ref) -> float:
    """Entries that differ, over the entries set in the reference (masks) or
    over all entries (counts)."""
    prog = torch.as_tensor(prog).to(ref.device)
    base = int(ref.sum()) if ref.dtype == torch.bool else ref.numel()
    return float((prog != ref).sum()) / max(base, 1)


def gram_gap(Hp, Hr) -> float:
    """max |Hp - Hr|_ij / sqrt(Hr_ii Hr_jj)."""
    Hp = torch.as_tensor(Hp, dtype=torch.float64).to(Hr.device)
    d = torch.sqrt(torch.clamp(torch.diagonal(Hr), min=1e-300))
    return float(((Hp - Hr).abs() / (d[:, None] * d[None, :])).max())


def rhs_gap(bp, br, Hr, S: float) -> float:
    """max |bp - br|_i / sqrt(Hr_ii S), S the weighted sum of squared
    residuals: |b_i| <= sqrt(H_ii S) bounds every entry."""
    bp = torch.as_tensor(bp, dtype=torch.float64).to(br.device)
    return float(((bp - br).abs() / torch.sqrt(torch.clamp(torch.diagonal(Hr) * S, min=1e-300))).max())


def relative_gap(a: float, b: float) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)


def h_norm(x, H) -> float:
    """|x| in the norm of H, sqrt(x^T H x)."""
    x = torch.as_tensor(x, dtype=torch.float64).to(H.device)
    return float(torch.sqrt(torch.clamp(x @ H @ x, min=0.0)))


def step_gap(xp, xr, Hr, norm=None) -> float:
    """|xp - xr| over ``norm`` (by default |xr|) in the norm of Hr,
    x^T Hr x: the update the program applied against the reference's, each
    variable weighted by what it does to the residuals (intrinsics in pixels
    and poses in metres and radians alike)."""
    d = torch.as_tensor(xp, dtype=torch.float64).to(xr.device) - xr
    return h_norm(d, Hr) / max(h_norm(xr, Hr) if norm is None else norm, 1e-300)


def verdict(numbers: dict, limits: dict):
    """(correct, rows): every number at or under its limit; a number that is
    not finite fails. Rows are (name, value, limit) in the limits' order."""
    rows = [(name, numbers.get(name, float("nan")), limit) for name, limit in limits.items()]
    return all(v == v and v <= lim for _, v, lim in rows), rows
