"""Multi-process practicals: per-rank camera ownership, the local view
batch, and sharded checkpoints (counterpart of
hairgs_tpu/parallel/multihost.py).

- Camera ownership is round robin over the ranks, so a rank loads only its
  own subset of the images.
- A torch process holds only its own views; `global_view_batch` checks that
  the ranks' local batches make up the global batch and hands the local
  one to the step.
- Sharded checkpoints keep JAX's file layout: `manifest.json` ({"step",
  "arrays": {key: {shape, dtype, replicated}}}) and one `shard_<rank>.npz`
  per rank holding `<key>__<starts>` blocks (row offset, then zeros) and,
  from rank 0 only, `<key>__R` for a replicated leaf. Keys are JAX's leaf
  paths: a NamedTuple field by name, a sequence item by index, a dict entry
  as ['key'] (dict keys sorted, as JAX flattens them). A checkpoint written
  by JAX loads here, and blocks are reassembled into whatever row ranges
  the loading ranks hold.

A torch tensor carries no sharding, so a sharded leaf is passed as a
`RowShard` (global shape, this rank's row offset, its block of rows); a
tensor or numpy array is a replicated leaf.
"""

import dataclasses
import json
import os
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from hairgs_tpu_torch.parallel.mesh import _world


def host_camera_indices(n_cameras: int, process_index: Optional[int] = None,
                        process_count: Optional[int] = None) -> List[int]:
    """Round-robin camera ownership: rank p loads cameras {i : i % P == p}
    (the process group's rank and size by default)."""
    rank, world = _world()
    p = rank if process_index is None else process_index
    n = world if process_count is None else process_count
    return [i for i in range(n_cameras) if i % n == p]


def global_view_batch(local_batch, mesh, axis_name: str = "data",
                      global_size: Optional[int] = None):
    """This rank's views of the global batch, checked: the ranks along
    `axis_name` hold equal counts (the even shards a mean over ranks
    needs), adding up to `global_size` when it is given. Returns
    `local_batch`, which the parallel steps take as it is."""
    count = torch.tensor([local_batch.world_view.shape[0]], dtype=torch.int64,
                         device=mesh.device)
    counts = mesh.all_gather(count, axis_name).reshape(-1).tolist()
    if len(set(counts)) != 1 or (global_size is not None
                                 and sum(counts) != global_size):
        raise ValueError(f"local view counts {counts} along {axis_name} do not "
                         f"make even shards of a batch of {global_size}")
    return local_batch


@dataclasses.dataclass
class RowShard:
    """One rank's block of rows of a leaf sharded along its first axis:
    rows [offset, offset + block.shape[0]) of an array of `shape`."""

    shape: tuple
    offset: int
    block: object  # torch.Tensor or np.ndarray


def _leaf_paths(tree, prefix=()) -> Dict[str, object]:
    """{path: leaf} with JAX's keys (see the module docstring); None
    leaves are dropped, as JAX has no leaf there."""
    out = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {"/".join(prefix): tree}
    for name, sub in items:
        out.update(_leaf_paths(sub, prefix + (name,)))
    return out


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_sharded_state(ckpt_dir: str, tree, step: int = 0) -> None:
    """Each rank writes its RowShard blocks to shard_<rank>.npz; rank 0
    also writes the replicated leaves and the manifest."""
    rank, _ = _world()
    os.makedirs(ckpt_dir, exist_ok=True)
    local = {}
    manifest = {"step": step, "arrays": {}}
    for key, leaf in _leaf_paths(tree).items():
        if isinstance(leaf, RowShard):
            block = _host(leaf.block)
            manifest["arrays"][key] = {"shape": list(leaf.shape),
                                       "dtype": str(block.dtype),
                                       "replicated": False}
            tag = "_".join(str(s) for s in (leaf.offset,) + (0,) * (block.ndim - 1))
            local[f"{key}__{tag}"] = block
            continue
        value = _host(leaf)
        manifest["arrays"][key] = {"shape": list(value.shape),
                                   "dtype": str(value.dtype), "replicated": True}
        if rank == 0:
            local[f"{key}__R"] = value
    np.savez(os.path.join(ckpt_dir, f"shard_{rank}.npz"), **local)
    if rank == 0:
        with open(os.path.join(ckpt_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f)


def _rows_from_blocks(blocks, key, lo, n_rows, meta):
    """Rows [lo, lo + n_rows) of `key`, copied from the stored blocks that
    cover them."""
    shape = tuple(meta["shape"])
    out = np.empty((n_rows,) + shape[1:], dtype=np.dtype(meta["dtype"]))
    filled = 0
    for start, read in sorted(blocks.get(key, []), key=lambda b: b[0]):
        block = read()
        a, b = max(lo, start), min(lo + n_rows, start + block.shape[0])
        if a < b:
            out[a - lo:b - lo] = block[a - start:b - start]
            filled += b - a
    if filled != n_rows:
        raise KeyError(f"load_sharded_state: rows [{lo}, {lo + n_rows}) of {key} "
                       f"are not all in the checkpoint")
    return out


def load_sharded_state(ckpt_dir: str, template_tree):
    """Rebuild the checkpoint in the template's structure: a RowShard leaf
    is filled with its row range (on its block's device and type), a
    tensor leaf gets the replicated value on its device, a numpy leaf a
    numpy array. Returns (tree, step). Every rank reads the whole
    directory (the shared file system of a multi-node run)."""
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    blocks: Dict[str, list] = {}
    replicated = {}
    for fname in sorted(os.listdir(ckpt_dir)):
        if not (fname.startswith("shard_") and fname.endswith(".npz")):
            continue
        z = np.load(os.path.join(ckpt_dir, fname))
        for name in z.files:
            key, tag = name.rsplit("__", 1)
            read = (lambda z=z, name=name: z[name])
            if tag == "R":
                replicated[key] = read
                continue
            starts = [int(s) for s in tag.split("_")]
            if any(starts[1:]):
                raise ValueError(f"{name}: only row-sharded blocks are supported")
            blocks.setdefault(key, []).append((starts[0], read))

    leaves = _leaf_paths(template_tree)
    # schema-drift guards: a renamed or added state field must not resume
    # silently from its fresh value, nor a stored one vanish unnoticed
    missing = sorted(k for k in leaves if k not in manifest["arrays"])
    if missing:
        raise KeyError(
            f"load_sharded_state: template leaves absent from checkpoint "
            f"manifest {missing} — schema drift? (checkpoint keys: "
            f"{sorted(manifest['arrays'])[:20]}...)")
    orphaned = sorted(k for k in manifest["arrays"] if k not in leaves)
    if orphaned:
        warnings.warn(f"load_sharded_state: checkpoint entries with no matching "
                      f"template leaf are ignored: {orphaned}")

    def value(key, leaf):
        meta = manifest["arrays"][key]
        if isinstance(leaf, RowShard):
            n_rows = leaf.block.shape[0]
            data = (replicated[key]()[leaf.offset:leaf.offset + n_rows]
                    if meta["replicated"]
                    else _rows_from_blocks(blocks, key, leaf.offset, n_rows, meta))
            return RowShard(tuple(meta["shape"]), leaf.offset, _like(data, leaf.block))
        if meta["replicated"]:
            data = replicated[key]()
        else:
            data = _rows_from_blocks(blocks, key, 0, meta["shape"][0], meta)
        return _like(data, leaf)

    filled = {key: value(key, leaf) for key, leaf in leaves.items()}
    return _rebuild(template_tree, filled, ()), manifest["step"]


def _like(data: np.ndarray, leaf):
    if torch.is_tensor(leaf):
        return torch.as_tensor(data).to(device=leaf.device, dtype=leaf.dtype)
    return np.asarray(data)


def _rebuild(tree, filled, prefix):
    """The template's structure with its leaves replaced from `filled`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, filled, prefix + (f"[{k!r}]",)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_rebuild(v, filled, prefix + (name,))
                            for name, v in zip(tree._fields, tree)])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, filled, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return filled["/".join(prefix)]
