"""Stage-I Gaussian point model, render surface (counterpart of
hairgs_tpu/models/gaussian.py:32-101), plus the functions that carry state
across from numpy (and so from the JAX package's host arrays).

Parameters live in fixed-capacity arenas with an `active` row mask, as in
the JAX package; the `GaussianModel` arena manager and densification are
not ported yet.
"""

from typing import NamedTuple

import numpy as np
import torch

from hairgs_tpu_torch.core.camera import Camera
from hairgs_tpu_torch.core.maths import safe_norm
from hairgs_tpu_torch.core.transforms import build_rotation
from hairgs_tpu_torch.optim import AdamState

# fused feature-channel layout for the single-pass renderer
RGB = slice(0, 3)
MASK = 3
ORIENT = slice(4, 7)
NUM_CHANNELS = 7


class GaussianParams(NamedTuple):
    xyz: torch.Tensor  # (N,3)
    features_dc: torch.Tensor  # (N,1,3)
    features_rest: torch.Tensor  # (N,K-1,3)
    scaling: torch.Tensor  # (N,3) log-space
    rotation: torch.Tensor  # (N,4) wxyz
    opacity: torch.Tensor  # (N,1) logit
    mask: torch.Tensor  # (N,1) logit


class GaussianStats(NamedTuple):
    max_radii2d: torch.Tensor  # (N,)
    xyz_grad_accum: torch.Tensor  # (N,1)
    denom: torch.Tensor  # (N,1)


def gaussian_activations(p: GaussianParams):
    # safe norm: zero-initialized padding rows get zero (not NaN) gradients
    qnorm = torch.maximum(safe_norm(p.rotation, dim=-1, keepdim=True),
                          p.rotation.new_tensor(1e-12))
    return {
        "scaling": torch.exp(p.scaling),
        "rotation": p.rotation / qnorm,
        "opacity": torch.sigmoid(p.opacity),
        "mask": torch.sigmoid(p.mask),
    }


def gaussian_orientation(p: GaussianParams):
    """World direction of the principal (longest-scale) axis; reference
    scene/gaussian_model.py:145-152. Ties pick the first axis, as argmax
    does in both frameworks."""
    scale = torch.exp(p.scaling)
    rots = build_rotation(p.rotation)
    main_axis = torch.nn.functional.one_hot(
        torch.argmax(scale, dim=1), 3).to(scale.dtype)
    return torch.einsum("nij,nj->ni", rots, main_axis)


def gaussian_render_inputs(p: GaussianParams, cam_center, active_sh_degree: int):
    """The fused renderer inputs; channels: rgb (SH, clamp >= 0),
    sigmoid(mask), world orientation."""
    from hairgs_tpu_torch.render.renderer import sh_to_color

    act = gaussian_activations(p)
    rgb = sh_to_color(p.features_dc, p.features_rest, p.xyz, cam_center,
                      active_sh_degree, 0)
    orient = gaussian_orientation(p)
    features = torch.cat([rgb, act["mask"], orient], dim=-1)
    return dict(
        means3d=p.xyz,
        scales=act["scaling"],
        rotations=act["rotation"],
        opacity=act["opacity"][:, 0],
        features=features,
    )


def _tensor(x, device, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def params_from_numpy(arrays: dict, device) -> GaussianParams:
    """GaussianParams from numpy arrays keyed like its fields (the layout of
    the JAX package's GaussianModel.host_arrays())."""
    return GaussianParams(**{k: _tensor(arrays[k], device)
                             for k in GaussianParams._fields})


def stats_from_numpy(arrays: dict, device) -> GaussianStats:
    return GaussianStats(**{k: _tensor(arrays[k], device)
                            for k in GaussianStats._fields})


def adam_state_from_numpy(moments: dict, step: int, device) -> AdamState:
    """AdamState from {"mu": {...}, "nu": {...}} keyed like GaussianParams
    (the layout of GaussianModel.host_moments())."""
    return AdamState(mu=params_from_numpy(moments["mu"], device),
                     nu=params_from_numpy(moments["nu"], device),
                     step=torch.tensor(step, dtype=torch.int32, device=device))


def camera_from_numpy(fields: dict, device) -> Camera:
    """Camera from numpy arrays keyed like its fields (None stays None)."""
    return Camera(**{k: None if fields.get(k) is None else _tensor(fields[k], device)
                     for k in Camera._fields})
