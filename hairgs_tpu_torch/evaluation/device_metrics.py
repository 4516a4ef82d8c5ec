"""Device-side reconstruction metrics for the in-training cadence
(counterpart of hairgs_tpu/evaluation/device_metrics.py).

The host oracle (`evaluation/metrics.py`) pulls the model and runs cKDTree
ball queries. Here the point-matching precision, recall and F1 are
computed on the model's device with masked ball queries: squared distances
in the expanded form |q|^2 + |p|^2 - 2 q.p and direction dots, both as
(queries, points) products (`torch.matmul`, as JAX leaves them to XLA),
then the thresholds and an any-reduction over the points.

The Python loop runs over blocks of `q_chunk` queries only; each block is
reduced over the points in a few wide blocks (`p_chunk` rounded up to about
2^26 pair entries per block), so a million GT points against ~100k
predicted ones costs a few hundred iterations per direction, not thousands.
The any-reduction makes the result independent of the blocking. All
thresholds of a direction share one pass over the pairs: the distances and
dots do not depend on the threshold, so each boolean result equals JAX's
one-threshold-at-a-time computation.

Strand consistency needs per-(gt strand, pred strand) vote counts, a
sparse reduction that stays on the host oracle, as in JAX.

`valid1`/`valid2` mask padded arena rows, so one call serves every eval of
a run whatever the live count.

The thresholds are 2-4 mm on a head of radius ~0.1 m: a TF32 product
(10-bit mantissa) errs by ~1e-5 there, on the order of the squared
threshold, and would decide matches at random. The products refuse to run
on the card with TF32 matmuls switched on (the package switches them off
when it is imported).
"""

import numpy as np
import torch

# pair entries per (query block x point block) product: 256 MB of fp32
PAIRS_PER_BLOCK = 1 << 26


def _check_fp32_matmul(t):
    if t.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32 is not False:
        raise RuntimeError("the device metrics' distance products must run in "
                           "full fp32: torch.backends.cuda.matmul.allow_tf32 is on")


def _thresholds(dist_th, cos_th, device):
    """fp32 squared distance and cosine thresholds as JAX forms them:
    dist_th in fp32, squared in fp32; cos_th already fp32."""
    d = torch.as_tensor(dist_th, dtype=torch.float32, device=device).reshape(-1)
    c = torch.as_tensor(cos_th, dtype=torch.float32, device=device).reshape(-1)
    return d * d, c


def _matched_masks(points1, dirs1, points2, dirs2, sq_ths, cos_ths,
                   valid1=None, valid2=None, bidirectional=False,
                   q_chunk: int = 1024, p_chunk: int = 8192):
    """(T, N1) bool: for each threshold pair t, the p1 points with some
    valid p2 point at squared distance <= sq_ths[t] whose direction dot
    (|dot| when bidirectional) is >= cos_ths[t]."""
    _check_fp32_matmul(points1)
    n_th = sq_ths.shape[0]
    if valid1 is not None:
        # padded rows never match: search with the valid rows only
        out = torch.zeros((n_th, points1.shape[0]), dtype=torch.bool,
                          device=points1.device)
        out[:, valid1] = _matched_masks(points1[valid1], dirs1[valid1], points2,
                                        dirs2, sq_ths, cos_ths, None, valid2,
                                        bidirectional, q_chunk, p_chunk)
        return out
    if valid2 is not None:
        points2, dirs2 = points2[valid2], dirs2[valid2]
    n1, n2 = points1.shape[0], points2.shape[0]
    out = torch.zeros((n_th, n1), dtype=torch.bool, device=points1.device)
    if n1 == 0 or n2 == 0:
        return out
    p_block = max(p_chunk, (PAIRS_PER_BLOCK // q_chunk) // p_chunk * p_chunk)
    with torch.no_grad():
        pp = torch.sum(points2 * points2, dim=-1)
        for q0 in range(0, n1, q_chunk):
            q = points1[q0:q0 + q_chunk]
            qq = torch.sum(q * q, dim=-1, keepdim=True)
            hit = out[:, q0:q0 + q_chunk]
            for p0 in range(0, n2, p_block):
                # (|q|^2 + |p|^2) - 2 (q.p), each step rounded as JAX does
                d = qq + pp[None, p0:p0 + p_block]
                d.sub_(torch.matmul(q, points2[p0:p0 + p_block].T).mul_(2.0))
                dots = torch.matmul(dirs1[q0:q0 + q_chunk],
                                    dirs2[p0:p0 + p_block].T)
                if bidirectional:
                    dots.abs_()
                for t in range(n_th):
                    hit[t] |= ((d <= sq_ths[t]) & (dots >= cos_ths[t])).any(dim=1)
    return out


def matched_mask(points1, dirs1, points2, dirs2, dist_th, cos_th,
                 valid1=None, valid2=None, bidirectional: bool = False,
                 q_chunk: int = 1024, p_chunk: int = 8192):
    """(N1,) bool: p1 points having some p2 point within `dist_th` whose
    direction dot exceeds `cos_th` (|dot| when bidirectional); padded rows
    (valid False) neither match nor are matched (loss/metrics.py:26-56)."""
    sq, c = _thresholds(dist_th, cos_th, points1.device)
    return _matched_masks(points1, dirs1, points2, dirs2, sq, c, valid1, valid2,
                          bidirectional, q_chunk, p_chunk)[0]


def _fractions(masks, valid1):
    """(T,) fp32 matched fraction of the valid p1 points, per threshold."""
    m = masks.to(torch.float32)
    if valid1 is None:
        return torch.mean(m, dim=1)
    denom = torch.clamp(torch.sum(valid1.to(torch.float32)), min=1.0)
    return torch.sum(m, dim=1) / denom


def matched_fraction(points1, dirs1, points2, dirs2, dist_th, angle_th_deg,
                     valid1=None, valid2=None, bidirectional=False,
                     q_chunk: int = 1024, p_chunk: int = 8192):
    """Scalar fraction of valid p1 points matched in p2 (a device tensor)."""
    cos_th = np.float32(np.cos(np.deg2rad(angle_th_deg)))
    m = matched_mask(points1, dirs1, points2, dirs2, dist_th, cos_th, valid1,
                     valid2, bidirectional=bidirectional, q_chunk=q_chunk,
                     p_chunk=p_chunk)
    return _fractions(m[None], valid1)[0]


def compute_metrics_device(pred_points, pred_dirs, gt_points, gt_dirs,
                           dist_ths=None, angle_ths=None, pred_valid=None,
                           gt_valid=None, bidirectional: bool = False,
                           q_chunk: int = 1024, p_chunk: int = 8192):
    """Precision, recall and F1 over the reference threshold grid, on the
    points' device.

    Returns the dict of `evaluation.metrics.compute_metrics` without
    strand_consistency, and the threshold labels; one transfer of
    2 x len(thresholds) scalars, no model pull."""
    from hairgs_tpu_torch.evaluation.metrics import DEFAULT_ANGLE_THS, DEFAULT_DIST_THS

    dist_ths = DEFAULT_DIST_THS if dist_ths is None else dist_ths
    angle_ths = DEFAULT_ANGLE_THS if angle_ths is None else angle_ths
    dev = pred_points.device
    sq, c = _thresholds(np.asarray(dist_ths, np.float32),
                        np.cos(np.deg2rad(np.asarray(angle_ths, np.float64)))
                        .astype(np.float32), dev)
    prec = _fractions(_matched_masks(pred_points, pred_dirs, gt_points, gt_dirs,
                                     sq, c, pred_valid, gt_valid, bidirectional,
                                     q_chunk, p_chunk), pred_valid)
    rec = _fractions(_matched_masks(gt_points, gt_dirs, pred_points, pred_dirs,
                                    sq, c, gt_valid, pred_valid, bidirectional,
                                    q_chunk, p_chunk), gt_valid)
    p, r = torch.stack([prec, rec]).cpu().numpy()
    denom = np.where(p + r > 0, p + r, 1.0)
    f1 = np.where(p + r > 0, 2 * p * r / denom, 0.0)
    suffix = "(b)" if bidirectional else ""
    thresholds = [f"{d}m&{a}°" for d, a in zip(dist_ths, angle_ths)]
    return {
        "precision" + suffix: p,
        "recall" + suffix: r,
        "f1" + suffix: f1,
    }, thresholds
