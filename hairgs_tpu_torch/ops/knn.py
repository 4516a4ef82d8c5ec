"""Brute-force chunked k-nearest-neighbour ops (counterpart of
hairgs_tpu/ops/knn.py).

Replaces simple-knn `distCUDA2` (used once, at model init) and pytorch3d
`knn_points`: per chunk of queries, all squared distances as
|q|^2 + |p|^2 - 2 q.p with one `torch.matmul` (the JAX package's form; not
`torch.cdist`, which switches formula with size), then `torch.topk`.

Hair points sit at millimetre spacing, where that form cancels
catastrophically unless the product is full fp32: on the card it refuses to
run with TF32 matmuls switched on (the package switches them off when it is
imported).
"""

import torch


def _check_fp32_matmul(t):
    if t.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32 is not False:
        raise RuntimeError("knn's distance products must run in full fp32: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")


def _chunk_dists(query_chunk, points, pp):
    """Squared distances (Q, N) via |q|^2 + |p|^2 - 2 q.p."""
    qq = torch.sum(query_chunk * query_chunk, dim=-1, keepdim=True)
    qp = torch.matmul(query_chunk, points.T)
    d = qq + pp[None, :] - 2.0 * qp
    return torch.clamp(d, min=0.0)


def knn(queries, points, k: int, valid=None, chunk: int = 1024):
    """k nearest neighbours of `queries` among `points`.

    Returns (sq_dists (Q,k), indices (Q,k) int64) sorted ascending. `valid`
    (N,) bool masks points out of consideration. A query that is also a
    point finds itself first, at distance 0 (pytorch3d semantics; callers
    drop it). Ties may come back in another order than JAX's top_k."""
    _check_fp32_matmul(points)
    pp = torch.sum(points * points, dim=-1)
    dists, idxs = [], []
    for start in range(0, queries.shape[0], chunk):
        d = _chunk_dists(queries[start:start + chunk], points, pp)
        if valid is not None:
            d = torch.where(valid[None, :], d, torch.full_like(d, float("inf")))
        dk, ik = torch.topk(d, k, dim=1, largest=False, sorted=True)
        dists.append(dk)
        idxs.append(ik)
    return torch.cat(dists), torch.cat(idxs)


def mean_sq_dist_3nn(points, valid=None, chunk: int = 1024):
    """Mean of squared distances to the 3 nearest neighbours (excluding
    self); parity target simple_knn distCUDA2 (spatial.cu:15-26), used at
    scene/gaussian_model.py:176-179 to set the initial scales."""
    d, _ = knn(points, points, k=4, valid=valid, chunk=chunk)
    # first hit is self (distance 0)
    return torch.mean(d[:, 1:4], dim=1)


def estimate_pointcloud_normals(points, k: int = 50, chunk: int = 1024):
    """Per-point normals via kNN-PCA (pytorch3d estimate_pointcloud_normals,
    used at reference data/hair_data.py:127): the eigenvector of each
    k-neighbourhood's covariance with the smallest eigenvalue, the
    self-match counted. The sign is arbitrary, as in the reference."""
    pts = points.to(torch.float32)
    k = min(k, pts.shape[0])
    _, idx = knn(pts, pts, k, chunk=chunk)
    nbrs = pts[idx]  # (N, k, 3)
    centered = nbrs - nbrs.mean(dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", centered, centered) / k
    _, vecs = torch.linalg.eigh(cov)  # ascending eigenvalues
    return vecs[..., 0]  # (N, 3), unit norm by construction
