"""Strand-specific regularizers (counterpart of hairgs_tpu/losses/strand.py).

Parity targets: loss/losses.py:175-221 (angle_smoothness_loss) and
loss/losses.py:106-172 (strand_joints_magnet_loss, disabled by default —
lambda_magnet = 0, arguments/__init__.py:93).

The host topology code builds the padded (M,2,2) consecutive-segment index
table after every topology change (c_utils.pyx:83-127 in the reference);
the losses run on the device on the endpoints inside the train step.
"""

import math

import torch

from hairgs_tpu_torch.core.maths import MIN_VAL, constant_like, safe_norm


def angle_smoothness_loss(endpoints, pair_indices, pair_valid,
                          threshold_deg: float = 30.0, eps: float = 1e-6):
    """Mean squared angle (rad) between consecutive segments that bend more
    than `threshold_deg`.

    endpoints: (E,3); pair_indices: (M,2,2) int — [[a,b],[b,c]] endpoint ids
    of consecutive segments; pair_valid: (M,) bool.
    """
    angle_sim_th = math.cos(math.radians(threshold_deg))
    pos = endpoints[pair_indices]  # (M,2,2,3)
    dirs = pos[:, :, 1] - pos[:, :, 0]  # (M,2,3)
    norm = safe_norm(dirs, dim=-1, keepdim=True)
    dirs = dirs / torch.maximum(norm, constant_like(MIN_VAL, norm))
    dots = torch.sum(dirs[:, 0] * dirs[:, 1], dim=-1)  # (M,)
    sel = pair_valid & (dots <= angle_sim_th)
    # jnp.clip's gradient at a bound is half (max/min split a tie);
    # torch.clamp would pass all of it
    dots = torch.minimum(torch.maximum(dots, constant_like(-1 + eps, dots)),
                         constant_like(1 - eps, dots))
    angles = torch.arccos(dots)
    count = torch.sum(sel)
    total = torch.sum(torch.where(sel, angles * angles, torch.zeros_like(angles)))
    return torch.where(count > 0, total / torch.clamp(count, min=1),
                       torch.zeros_like(total))


def strand_joints_magnet_loss(endpoints, strand_endpoint_ids, complementary_ids,
                              valid):
    """Attract free strand endpoints toward their nearest non-self neighbor.

    endpoints: (E,3); strand_endpoint_ids/complementary_ids: (M,) int padded;
    valid: (M,) bool. Follows loss/losses.py:106-172: among the top-3 nearest
    strand endpoints pick the first that is neither self nor the strand's own
    complementary tip, and penalize the squared squared distance.

    The top 3 come from a stable ascending sort of each row, so ties go to
    the lower index as in `lax.top_k` (torch.topk promises no tie order);
    columns of invalid rows are +inf and sort last. The M x M table holds
    every pair of tips.
    """
    pts = endpoints[strand_endpoint_ids]  # (M,3)
    comp_pts = endpoints[complementary_ids]
    self_dir = (pts - comp_pts).detach()
    norm = torch.linalg.vector_norm(self_dir, dim=1)
    valid = valid & (norm > MIN_VAL)

    # all-pairs distances among the (padded) strand endpoints
    d2 = torch.sum((pts[:, None, :] - pts[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(valid[None, :], d2, torch.full_like(d2, math.inf))
    idx = torch.sort(d2.detach(), dim=1, stable=True).indices[:, :3]
    sq_dists = torch.gather(d2, 1, idx)  # (M,3) ascending
    m = pts.shape[0]
    self_idx = torch.arange(m, device=pts.device)
    # the complementary of a listed endpoint is itself listed (the
    # reference maps it via endpoint_mapping)
    second_ok = (idx[:, 1] != self_idx) & (
        strand_endpoint_ids[idx[:, 1]] != complementary_ids
    )
    chosen_d2 = torch.where(second_ok, sq_dists[:, 1], sq_dists[:, 2])
    chosen_d2 = torch.where(valid, chosen_d2, torch.zeros_like(chosen_d2))
    dists = chosen_d2 * chosen_d2  # the reference squares the squared distance
    count = torch.clamp(torch.sum(valid), min=1)
    return torch.sum(dists) / count
