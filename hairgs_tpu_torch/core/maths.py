"""Small math helpers (counterpart of hairgs_tpu/core/maths.py)."""

import torch

MIN_VAL = 1e-7  # reference GaussianModel.min_val (scene/gaussian_model.py:34)


def inverse_sigmoid(x):
    """log(x / (1-x)); reference utils/general.py:22."""
    return torch.log(x / (1 - x))


def safe_norm(x, dim=-1, keepdim=False, eps=1e-24):
    """L2 norm as sqrt(sum(x^2) + eps): zero gradient at the origin, where
    torch.linalg.norm's would be NaN and poison masked-out rows."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)
