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

from collections.abc import Sequence
from typing import NamedTuple, Optional

import numpy as np
from scipy.spatial import cKDTree


class Strands(Sequence):
    """Per-strand arrays held in one flat array: strand `i` is the view
    `flat[offsets[i]:offsets[i + 1]]`. The walk returns this form, and the
    topology events and the strand tables read it whole, so a graph of
    ~10^5 strands makes no ~10^5 small arrays per walk."""

    def __init__(self, flat: np.ndarray, offsets: np.ndarray):
        self.flat = flat
        self.offsets = offsets

    @classmethod
    def from_list(cls, arrays, empty_shape=(0,)):
        """The flat form of a list of per-strand arrays."""
        if isinstance(arrays, cls):
            return arrays
        lengths = [a.shape[0] for a in arrays]
        offsets = np.zeros(len(lengths) + 1, np.int64)
        np.cumsum(lengths, out=offsets[1:])
        flat = (np.concatenate(arrays, axis=0) if lengths
                else np.zeros(empty_shape, np.int64))
        return cls(flat, offsets)

    def __len__(self):
        return self.offsets.shape[0] - 1

    def __getitem__(self, i: int):
        n = len(self)
        if not -n <= i < n:
            raise IndexError(i)
        i %= n
        return self.flat[self.offsets[i]:self.offsets[i + 1]]

    def __iter__(self):
        return iter(np.split(self.flat, self.offsets[1:-1])) if len(self) else iter(())

    def strand_of_each(self) -> np.ndarray:
        """(len(flat),) the strand each flat row belongs to."""
        return np.repeat(np.arange(len(self)), np.diff(self.offsets))


class StrandsInfo(NamedTuple):
    list_strands: Strands  # each (num_segments, 2) endpoint ids, root->tip
    list_strands_segments_id: Strands  # each (num_segments,) row ids
    id_to_strand_id: np.ndarray  # (E,) int32, -1 where unassigned
    strand_endpoint_id_to_complementary: np.ndarray  # (E,) int32


def _walk_strands(endpoint_pairs: np.ndarray, num_endpoints: int,
                  native: bool = True):
    """Walk every path component: returns (strands, strand_rows, id2strand,
    complementary) with strands ordered from their discovered start
    endpoint, the first two as `Strands`."""
    if native:
        from hairgs_tpu_torch.native import walk_strands

        seq, rows, offsets, id_to_strand, complementary = walk_strands(
            endpoint_pairs, num_endpoints)
        return Strands(seq, offsets), Strands(rows, offsets), id_to_strand, complementary
    strands, strand_rows, id_to_strand, complementary = _walk_strands_np(
        endpoint_pairs, num_endpoints)
    return (Strands.from_list(strands, (0, 2)), Strands.from_list(strand_rows),
            id_to_strand, complementary)


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


def compute_strands_info(model, arrays=None, native: bool = True,
                         store: bool = True) -> StrandsInfo:
    """Build StrandsInfo of the foreground segments of a HairModel, store
    it on the model and return it. `arrays` lets callers reuse an existing
    host mirror (topology events); otherwise only the planes the walk needs
    are pulled. `store=False` leaves the model alone (the async topology
    worker walks a snapshot while the model trains)."""
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
    # (hair_gaussian_model.py:1481-1489): a flipped strand's rows run in
    # reverse order, each with its two endpoints swapped
    tree = cKDTree(model.ref_strand_root)
    if len(strands):
        off = strands.offsets
        tips = np.concatenate([strands.flat[off[:-1], 0], strands.flat[off[1:] - 1, 1]])
        d, _ = tree.query(endpoints[tips], k=1, workers=-1)
        flip = d[:len(strands)] > d[len(strands):]  # start farther than end
        if flip.any():
            sid = strands.strand_of_each()
            flipped = flip[sid]
            pos = np.arange(sid.shape[0])
            src = np.where(flipped, off[sid] + off[sid + 1] - 1 - pos, pos)
            seq = strands.flat[src]
            seq[flipped] = seq[flipped][:, ::-1]
            strands = Strands(seq, off)
            strand_rows = Strands(strand_rows.flat[src], off)

    info = StrandsInfo(
        list_strands=strands,
        list_strands_segments_id=strand_rows,
        id_to_strand_id=id_to_strand,
        strand_endpoint_id_to_complementary=complementary,
    )
    if store:
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
    (or to a 1024 bucket of zero rows, as JAX's table). Padding rows are
    invalid and change no loss value. Padded to `max_pairs` (the train
    driver gives the segment arena, so tens of thousands of rows), padding
    row j points all four entries at endpoint j (modulo the endpoints in
    use): the gather's backward on the card sums the rows of one endpoint
    serially, and one endpoint under every padding row would make that run
    as long as the padding.
    """
    strands = Strands.from_list(info.list_strands, (0, 2))
    sid = strands.strand_of_each()
    first = np.flatnonzero(sid[:-1] == sid[1:])  # rows followed in their strand
    pairs = np.stack([strands.flat[first], strands.flat[first + 1]],
                     axis=1).astype(np.int32).reshape(-1, 2, 2)
    m = pairs.shape[0]
    spread = max_pairs is not None
    if max_pairs is None:
        max_pairs = max(1024, ((m + 1023) // 1024) * 1024)
    assert m <= max_pairs
    out = np.zeros((max_pairs, 2, 2), dtype=np.int32)
    out[:m] = pairs
    if spread and strands.flat.size:
        out[m:] = (np.arange(max_pairs - m) % (int(strands.flat.max()) + 1))[:, None, None]
    valid = np.zeros(max_pairs, dtype=bool)
    valid[:m] = True
    return out, valid
