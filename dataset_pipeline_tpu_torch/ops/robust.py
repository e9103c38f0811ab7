"""Robust cost weighting (Huber / Tukey / none).

Port of ``dataset_pipeline_tpu/ops/robust.py``: rho(r) for cost evaluation
and w(r) = rho'(r)/r for IRLS weighting of squared residuals. Defaults:
colours Huber with parameter ``30*sqrt(5)/sqrt(2)``, depth Tukey 0.02.
"""

from __future__ import annotations

import torch


def huber_rho(r, k):
    a = torch.abs(r)
    return torch.where(a <= k, 0.5 * r * r, k * (a - 0.5 * k))


def huber_weight(r, k):
    a = torch.abs(r)
    # k / a as a division: torch evaluates ``scalar / tensor`` as a
    # reciprocal times the scalar, one ulp off the quotient
    return torch.where(a <= k, torch.ones_like(a), torch.full_like(a, k) / torch.clamp(a, min=1e-30))


def tukey_rho(r, k):
    k2 = k * k
    inner = 1.0 - (r / k) ** 2
    return torch.where(torch.abs(r) <= k, (k2 / 6.0) * (1.0 - inner ** 3),
                       torch.full_like(r, k2 / 6.0))


def tukey_weight(r, k):
    inner = 1.0 - (r / k) ** 2
    return torch.where(torch.abs(r) <= k, inner * inner, torch.zeros_like(r))


def none_rho(r, k=None):
    return 0.5 * r * r


def none_weight(r, k=None):
    return torch.ones_like(r)


ROBUST = {
    "huber": (huber_rho, huber_weight),
    "tukey": (tukey_rho, tukey_weight),
    "none": (none_rho, none_weight),
}

# reference defaults (opt/parameters.h)
DEFAULT_COLOR_HUBER = 30.0 * (5.0 ** 0.5) / (2.0 ** 0.5)
DEFAULT_DEPTH_TUKEY = 0.02
