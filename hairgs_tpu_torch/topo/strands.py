"""Strand-graph traversal and bookkeeping on the host (counterpart of
hairgs_tpu/topo/strands.py).

Parity targets:
- compute_strands_info: scene/hair_gaussian_model.py:1410-1498 — walk the
  endpoint-pair graph into per-strand ordered segment lists, root-
  disambiguated by distance to the reference scalp points.
- update_strand_root: scene/hair_gaussian_model.py:1373-1399 (kNN of scalp
  verts to endpoints with a *squared*-distance threshold, pytorch3d
  semantics).
- filter_strand_list_segments: c_utils/c_utils.pyx:83-127 — consecutive
  segment index pairs for the smoothness loss.

The walk runs in the native library (`hairgs_tpu_torch.native`);
`_walk_strands_np` is its numpy oracle, run only when a caller passes
`native=False`.
"""

from typing import List, NamedTuple, Optional

import numpy as np
from scipy.spatial import cKDTree


class StrandsInfo(NamedTuple):
    list_strands: List[np.ndarray]  # each (num_segments, 2) endpoint ids, root->tip
    list_strands_segments_id: List[np.ndarray]  # each (num_segments,) row ids
    id_to_strand_id: np.ndarray  # (E,) int32, -1 where unassigned
    strand_endpoint_id_to_complementary: np.ndarray  # (E,) int32


def _walk_strands(endpoint_pairs: np.ndarray, num_endpoints: int,
                  native: bool = True):
    """Walk every path component: returns (strands, strand_rows, id2strand,
    complementary) with strands ordered from their discovered start
    endpoint."""
    if native:
        from hairgs_tpu_torch.native import walk_strands

        return walk_strands(endpoint_pairs, num_endpoints)
    return _walk_strands_np(endpoint_pairs, num_endpoints)


def _walk_strands_np(endpoint_pairs: np.ndarray, num_endpoints: int):
    # endpoint -> up to two incident rows
    id_to_row = -np.ones((num_endpoints, 2), dtype=np.int64)
    for row_id, (a, b) in enumerate(endpoint_pairs):
        for idx in (a, b):
            col = 0 if id_to_row[idx, 0] == -1 else 1
            id_to_row[idx, col] = row_id
    ids, counts = np.unique(endpoint_pairs, return_counts=True)
    strand_endpoint_id = ids[counts == 1]

    id_to_strand = -np.ones(num_endpoints, dtype=np.int32)
    complementary = -np.ones(num_endpoints, dtype=np.int32)
    visited = np.zeros(num_endpoints, dtype=bool)
    strands, strand_rows = [], []
    for start in strand_endpoint_id:
        if visited[start]:
            continue
        cur = start
        row = id_to_row[cur, 0]
        seq, rows = [], []
        strand_no = len(strands)
        while row != -1:
            id_to_strand[cur] = strand_no
            a, b = endpoint_pairs[row]
            nxt = a if a != cur else b
            seq.append((cur, nxt))
            rows.append(row)
            cur = nxt
            row = id_to_row[cur, 0] if id_to_row[cur, 0] != row else id_to_row[cur, 1]
        complementary[start] = cur
        complementary[cur] = start
        visited[start] = True
        visited[cur] = True
        id_to_strand[cur] = strand_no
        strands.append(np.array(seq, dtype=np.int64))
        strand_rows.append(np.array(rows, dtype=np.int64))
    return strands, strand_rows, id_to_strand, complementary


def compute_strands_info(model, arrays=None, native: bool = True) -> StrandsInfo:
    """Build StrandsInfo of the foreground segments of a HairModel, store
    it on the model and return it. `arrays` lets callers reuse an existing
    host mirror (topology events); otherwise only the planes the walk needs
    are pulled."""
    if model.ref_strand_root is None or model.ref_strand_root.shape[0] == 0:
        raise ValueError("ref_strand_root is not set")
    if arrays is None:
        arrays = model.host_arrays(
            keys=("endpoints", "endpoint_pairs", "opacity", "mask"))
    endpoints = arrays["endpoints"]
    fg = model.compute_foreground_mask_np(arrays)
    endpoint_pairs = arrays["endpoint_pairs"].astype(np.int64)[fg]

    strands, strand_rows, id_to_strand, complementary = _walk_strands(
        endpoint_pairs, endpoints.shape[0], native=native)

    # root disambiguation: flip so the end closer to the scalp comes first
    # (hair_gaussian_model.py:1481-1489)
    tree = cKDTree(model.ref_strand_root)
    if strands:
        starts = np.array([s[0, 0] for s in strands])
        ends = np.array([s[-1, 1] for s in strands])
        d_start, _ = tree.query(endpoints[starts], k=1)
        d_end, _ = tree.query(endpoints[ends], k=1)
        for i in np.nonzero(d_start > d_end)[0]:
            strands[i] = np.flip(np.flip(strands[i], axis=1), axis=0).copy()
            strand_rows[i] = np.flip(strand_rows[i]).copy()

    info = StrandsInfo(
        list_strands=strands,
        list_strands_segments_id=strand_rows,
        id_to_strand_id=id_to_strand,
        strand_endpoint_id_to_complementary=complementary,
    )
    model.strands_info = info
    return info


def update_strand_root(model, dist_th: float = 1e-2):
    """Mark endpoints near reference scalp verts as strand roots.

    NOTE: the reference compares pytorch3d knn *squared* distances against
    dist_th (hair_gaussian_model.py:1388-1391); replicated as-is."""
    if model.ref_strand_root is None or model.ref_strand_root.shape[0] == 0:
        return
    endpoints = model.host_arrays(keys=("endpoints",))["endpoints"]
    tree = cKDTree(endpoints)
    d, nn = tree.query(model.ref_strand_root, k=1)
    selected = nn[(d * d) <= dist_th]
    mask = np.zeros(endpoints.shape[0], dtype=bool)
    mask[selected] = True
    model.strand_root_endpoint_idx = np.nonzero(mask)[0].astype(np.int64)


def magnet_indices(model):
    """Free strand endpoints + the other end of each tip's OWN segment for
    the magnet loss (loss/losses.py:117-126 pairs the tips with their
    *segment* complementary, which defines the tip direction), padded to a
    256 bucket."""
    pairs = model.host_arrays(keys=("endpoint_pairs",))["endpoint_pairs"].astype(np.int64)
    ids_all, counts = np.unique(pairs, return_counts=True)
    tips = ids_all[counts == 1].astype(np.int32)
    # segment complementary: the other column of the single row holding a tip
    mapping = -np.ones(int(pairs.max()) + 1, dtype=np.int64)
    rows = np.arange(pairs.shape[0])
    mapping[pairs[:, 0]] = rows
    mapping[pairs[:, 1]] = rows
    row = mapping[tips]
    sel = pairs[row]
    comp = np.where(sel[:, 1] == tips, sel[:, 0], sel[:, 1]).astype(np.int32)
    m = tips.shape[0]
    max_endpoints = max(256, ((m + 255) // 256) * 256)
    out_ids = np.zeros(max_endpoints, np.int32)
    out_comp = np.zeros(max_endpoints, np.int32)
    out_ids[:m] = tips
    out_comp[:m] = comp
    valid = np.zeros(max_endpoints, bool)
    valid[:m] = True
    return out_ids, out_comp, valid


def smooth_pair_indices(info: StrandsInfo, max_pairs: Optional[int] = None):
    """Consecutive-segment endpoint index pairs for the smoothness loss
    (c_utils.pyx:83-127 filter_strand_list_segments): for every strand with
    >= 2 segments, rows [[a,b],[b,c]] for each consecutive pair.

    Returns (pairs (M,2,2) int32, valid (M,) bool) padded to `max_pairs`
    (or to a 1024 bucket).
    """
    chunks = [
        np.stack([s[:-1], s[1:]], axis=1)
        for s in info.list_strands
        if s.shape[0] >= 2
    ]
    if chunks:
        pairs = np.concatenate(chunks, axis=0).astype(np.int32)
    else:
        pairs = np.zeros((0, 2, 2), dtype=np.int32)
    m = pairs.shape[0]
    if max_pairs is None:
        max_pairs = max(1024, ((m + 1023) // 1024) * 1024)
    assert m <= max_pairs
    out = np.zeros((max_pairs, 2, 2), dtype=np.int32)
    out[:m] = pairs
    valid = np.zeros(max_pairs, dtype=bool)
    valid[:m] = True
    return out, valid
