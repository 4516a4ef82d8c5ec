"""Small math helpers (counterpart of hairgs_tpu/core/maths.py)."""

import functools
import math
import statistics

import torch

MIN_VAL = 1e-7  # reference GaussianModel.min_val (scene/gaussian_model.py:34)


def inverse_sigmoid(x):
    """log(x / (1-x)); reference utils/general.py:22."""
    return torch.log(x / (1 - x))


def safe_norm(x, dim=-1, keepdim=False, eps=1e-24):
    """L2 norm as sqrt(sum(x^2) + eps): zero gradient at the origin, where
    torch.linalg.norm's would be NaN and poison masked-out rows."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


@functools.lru_cache(maxsize=64)
def _constant(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):  # autograd may save it for a backward
        if isinstance(value, tuple):
            return torch.stack([torch.full((), v, dtype=dtype, device=device)
                                for v in value])
        return torch.full((), value, dtype=dtype, device=device)


def constant_like(value, t: torch.Tensor) -> torch.Tensor:
    """`value` (a number, or a tuple of numbers for a vector) as a 0-d (or
    1-d) tensor of t's dtype on t's device, made once per (value, dtype,
    device) by fills on the device: a step that compares against it copies
    nothing from the host, so it never waits for the device and a CUDA
    graph can capture it. Read-only: every caller shares it."""
    return _constant(value, t.dtype, t.device)


def normal_icdf(q):
    """Standard normal inverse CDF in float64 on the host: the stdlib's
    rational approximation, then two Newton steps on the erf CDF (the JAX
    package's formula, so both give the same factor)."""
    x = statistics.NormalDist().inv_cdf(q)
    for _ in range(2):
        cdf = 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
        pdf = math.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)
        x -= (cdf - q) / pdf
    return x


def pval_to_dist_to_scale_factor(pval: float) -> float:
    """dist_to_scale_factor = 1 / icdf(1 - pval/2); reference
    scene/gaussian_model.py:696-704 (set_pval)."""
    return 1.0 / normal_icdf(1.0 - pval / 2.0)


def dist_to_scale_factor_to_pval(factor: float) -> float:
    """Inverse of the above; reference scene/gaussian_model.py:686-694."""
    x = 1.0 / factor
    cdf = 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
    return 2.0 * (1.0 - cdf)
