"""Stage-II/III strand-graph model (HairGS) on capacity-padded arenas
(counterpart of hairgs_tpu/models/hair.py).

Parity target: reference scene/hair_gaussian_model.py — learnable endpoints
(E,3) plus an integer segment graph endpoint_pairs (S,2); per-segment
features/opacity/mask/width. All Gaussian parameters are *derived* from the
endpoints (l.134-201): scaling from segment length + width, rotation
aligning the x-axis to the segment, xyz = midpoint, orientation =
normalized direction; autograd differentiates through them.

Topology operations (split/clone/merge/collapse/prune/grow, l.788-1203) run
on the host between train steps on the live rows, then reinstall a
capacity-rounded arena; the Adam moments stay on the device and move by
gather-or-zero index maps (hairgs_tpu_torch/topo/graph_ops.py).
"""

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from hairgs_tpu_torch import resolve_device
from hairgs_tpu_torch.core.maths import (
    MIN_VAL,
    constant_like,
    dist_to_scale_factor_to_pval,
    pval_to_dist_to_scale_factor,
    safe_norm,
)
from hairgs_tpu_torch.core.transforms import quaternion_between_vectors
from hairgs_tpu_torch.models.gaussian import (
    FG_BIN_TH,
    OPACITY_TH,
    GaussianStats,
    _pad_to,
    _round_capacity,
)
from hairgs_tpu_torch.optim import AdamState, adam_init


class HairParams(NamedTuple):
    """Differentiable leaves. endpoints is (E,3); everything else (S,...)."""

    endpoints: torch.Tensor  # (E,3)
    features_dc: torch.Tensor  # (S,1,3)
    features_rest: torch.Tensor  # (S,K-1,3)
    opacity: torch.Tensor  # (S,1) logit
    mask: torch.Tensor  # (S,1) logit
    width: torch.Tensor  # (S,1) log


class HairGraph(NamedTuple):
    """Non-differentiable topology state (padded)."""

    endpoint_pairs: torch.Tensor  # (S,2) int64 (torch indexes with int64)
    seg_active: torch.Tensor  # (S,) bool
    ep_active: torch.Tensor  # (E,) bool


def _floor(x, lo: float):
    """max(x, lo) with JAX's gradient: jnp.maximum and jnp.clip split it
    at a tie, torch.maximum does too, torch.clamp passes all of it."""
    return torch.maximum(x, constant_like(lo, x))


def hair_derived(p: HairParams, graph: HairGraph, dist_to_scale_factor: float):
    """Derived per-segment Gaussian parameters (hair_gaussian_model.py:
    134-201). Pad rows point at endpoint 0 twice and collapsed segments have
    zero length: `safe_norm` and the `where` on a safe direction keep every
    gradient finite there, as in JAX."""
    pairs = p.endpoints[graph.endpoint_pairs]  # (S,2,3)
    diff = pairs[:, 1] - pairs[:, 0]
    norm = safe_norm(diff, dim=-1, keepdim=True)
    # scaling (l.134-145): x from half-length * factor, yz from width
    scale_x = _floor(norm / 2.0 * dist_to_scale_factor, MIN_VAL)
    scale_yz = torch.exp(torch.repeat_interleave(p.width, 2, dim=1))
    scaling = torch.cat([scale_x, scale_yz], dim=1)
    # rotation (l.147-165): align +x to the segment; identity for collapsed
    valid = (norm[:, 0] > MIN_VAL)[:, None]
    v1 = constant_like((1.0, 0.0, 0.0), diff).expand(diff.shape)
    safe_diff = torch.where(valid, diff, v1)
    quat = quaternion_between_vectors(v1, safe_diff)
    identity = constant_like((1.0, 0.0, 0.0, 0.0), diff).expand(quat.shape)
    rotation = torch.where(valid, quat, identity)
    # xyz = midpoint (l.167-172)
    xyz = torch.mean(pairs, dim=1)
    # orientation (l.188-201): normalized direction, +x for collapsed
    direction = torch.where(valid, diff / _floor(norm, MIN_VAL), v1)
    return dict(xyz=xyz, scaling=scaling, rotation=rotation, orientation=direction)


def hair_render_inputs(p: HairParams, graph: HairGraph, cam_center,
                       active_sh_degree: int, dist_to_scale_factor: float):
    """Fused multi-channel renderer inputs for the hair model."""
    from hairgs_tpu_torch.render.renderer import sh_to_color

    d = hair_derived(p, graph, dist_to_scale_factor)
    rgb = sh_to_color(p.features_dc, p.features_rest, d["xyz"], cam_center,
                      active_sh_degree, 0)
    features = torch.cat([rgb, torch.sigmoid(p.mask), d["orientation"]], dim=-1)
    return dict(
        means3d=d["xyz"],
        scales=d["scaling"],
        rotations=d["rotation"],
        opacity=torch.sigmoid(p.opacity)[:, 0],
        features=features,
    )


def _arena(host: dict, cap_e: int, cap_s: int, device) -> HairParams:
    return HairParams(**{
        k: torch.tensor(_pad_to(np.asarray(host[k], np.float32),
                                cap_e if k == "endpoints" else cap_s),
                        device=device)
        for k in HairParams._fields})


@dataclasses.dataclass
class HairModel:
    """Host-side wrapper around the padded hair arena, with the JAX
    package's API; the train step consumes params/graph/stats/opt_state
    directly. Every tensor lives on `device` ("cuda" unless the caller asks
    for the CPU)."""

    sh_degree: int = 0
    spatial_lr_scale: float = 1.0
    capacity_round: int = 4096
    device: str = "cuda"

    params: Optional[HairParams] = None
    graph: Optional[HairGraph] = None
    stats: Optional[GaussianStats] = None
    opt_state: Optional[AdamState] = None
    num_endpoints: int = 0
    num_segments: int = 0
    active_sh_degree: int = 0
    pval: float = 0.05
    dist_to_scale_factor: float = pval_to_dist_to_scale_factor(0.05)
    training_args: Optional[object] = None
    ref_strand_root: Optional[np.ndarray] = None  # (R,3) scalp vertices
    strand_root_endpoint_idx: Optional[np.ndarray] = None  # (n,) int
    strands_info: Optional[object] = None
    max_segment_length: float = 0.0
    merge_dist_th: float = 2e-3
    merge_angle_th: float = 20.0

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def max_sh_degree(self) -> int:
        return self.sh_degree

    @property
    def capacity(self) -> int:
        """Rows of the segment arena (what the renderer sees)."""
        return 0 if self.graph is None else self.graph.endpoint_pairs.shape[0]

    def set_pval(self, pval: float):
        self.pval = pval
        self.dist_to_scale_factor = pval_to_dist_to_scale_factor(pval)

    def set_dist_to_scale_factor(self, factor: float):
        self.dist_to_scale_factor = factor
        self.pval = dist_to_scale_factor_to_pval(factor)

    def oneup_sh_degree(self):
        if self.active_sh_degree < self.max_sh_degree:
            self.active_sh_degree += 1

    # -- arena management ------------------------------------------------

    def install(self, endpoints: np.ndarray, endpoint_pairs: np.ndarray,
                seg_arrays: dict, moments: Optional[dict] = None, step: int = 0,
                moment_maps=None, carry_param_values: bool = False):
        """Write host arrays into (re)padded device arenas.

        seg_arrays: features_dc / features_rest / opacity / mask / width.
        moments (optional): {"mu": {...}, "nu": {...}} including "endpoints".
        moment_maps (optional): (ep_src, seg_src, zero_planes) gather-or-zero
        index maps into the CURRENT opt_state rows (-1 = zero-init), applied
        on the device: the moments never come to the host.
        carry_param_values: surviving rows (src >= 0) take their CURRENT
        device parameter values instead of the host arrays (the host mirror
        is then authoritative only for new rows). Requires moment_maps and a
        surgery that never value-mutates surviving rows (cat/prune/re-link
        only).
        """
        dev = self.device
        ne = endpoints.shape[0]
        ns = endpoint_pairs.shape[0]
        cap_e = _round_capacity(ne, self.capacity_round)
        cap_s = _round_capacity(ns, self.capacity_round)
        host = dict(seg_arrays, endpoints=endpoints)
        host_params = _arena(host, cap_e, cap_s, dev)

        remapped = None
        carried = None
        if moment_maps is not None and self.opt_state is not None:
            ep_src, seg_src, zero_planes = moment_maps

            def dev_map(src, cap):
                src_cap = np.full(cap, -1, np.int64)
                src_cap[: src.shape[0]] = src
                idx = torch.tensor(np.clip(src_cap, 0, None), device=dev)
                live = torch.tensor(src_cap >= 0, device=dev)

                def take(name, arr, fallback=None):
                    if fallback is None and name in zero_planes:
                        return torch.zeros((cap,) + tuple(arr.shape[1:]),
                                           dtype=arr.dtype, device=dev)
                    g = arr[idx]
                    lv = live.reshape((-1,) + (1,) * (g.ndim - 1))
                    return torch.where(lv, g, torch.zeros_like(g)
                                       if fallback is None else fallback)

                return take

            take_e = dev_map(ep_src, cap_e)
            take_s = dev_map(seg_src, cap_s)

            def remap_tree(tree, fallbacks=None):
                def pick(name, arr):
                    fb = getattr(fallbacks, name) if fallbacks is not None else None
                    return (take_e if name == "endpoints" else take_s)(name, arr, fb)

                return HairParams(**{name: pick(name, getattr(tree, name))
                                     for name in HairParams._fields})

            remapped = AdamState(
                mu=remap_tree(self.opt_state.mu),
                nu=remap_tree(self.opt_state.nu),
                step=torch.tensor(step, dtype=torch.int32, device=dev),
            )
            if carry_param_values and self.params is not None:
                assert not zero_planes, (
                    "carry_param_values cannot express host-mutated planes")
                carried = remap_tree(self.params, fallbacks=host_params)
        if carried is not None:
            self.params = carried
        else:
            assert not carry_param_values, (
                "carry_param_values requires moment_maps and live opt_state")
            self.params = host_params
        pairs = _pad_to(np.asarray(endpoint_pairs, np.int64), cap_s)
        self.graph = HairGraph(
            endpoint_pairs=torch.tensor(pairs, device=dev),
            seg_active=torch.arange(cap_s, device=dev) < ns,
            ep_active=torch.arange(cap_e, device=dev) < ne,
        )
        self.num_endpoints = ne
        self.num_segments = ns
        self.stats = GaussianStats(
            max_radii2d=torch.zeros((cap_s,), dtype=torch.float32, device=dev),
            xyz_grad_accum=torch.zeros((cap_s, 1), dtype=torch.float32, device=dev),
            denom=torch.zeros((cap_s, 1), dtype=torch.float32, device=dev),
        )
        if remapped is not None:
            self.opt_state = remapped
        elif moments is None:
            self.opt_state = adam_init(self.params)
        else:
            self.opt_state = AdamState(
                mu=_arena(moments["mu"], cap_e, cap_s, dev),
                nu=_arena(moments["nu"], cap_e, cap_s, dev),
                step=torch.tensor(step, dtype=torch.int32, device=dev))

    def host_arrays(self, keys=None):
        """The live rows of (a subset of) the arenas on the host, one
        `.cpu()` per plane; callers that need a few planes pass `keys` (the
        strand walk needs endpoints/pairs/opacity/mask, not features)."""
        from hairgs_tpu_torch.core.hostsync import sliced_pull

        e, s = self.num_endpoints, self.num_segments
        p = self.params
        sources = dict(
            endpoints=(p.endpoints, e),
            endpoint_pairs=(self.graph.endpoint_pairs, s),
            features_dc=(p.features_dc, s),
            features_rest=(p.features_rest, s),
            opacity=(p.opacity, s),
            mask=(p.mask, s),
            width=(p.width, s),
        )
        if keys is None:
            keys = sources.keys()
        return sliced_pull({k: sources[k] for k in keys})

    def host_moments(self):
        from hairgs_tpu_torch.core.hostsync import sliced_pull

        e, s = self.num_endpoints, self.num_segments
        out = {}
        for g in ("mu", "nu"):
            tree = getattr(self.opt_state, g)
            out[g] = sliced_pull({k: (v, e if k == "endpoints" else s)
                                  for k, v in tree._asdict().items()})
        return out

    def np_opacity(self, arrays):
        return 1.0 / (1.0 + np.exp(-arrays["opacity"]))

    def np_mask(self, arrays):
        return 1.0 / (1.0 + np.exp(-arrays["mask"]))

    def np_scaling(self, arrays):
        """Derived per-segment scaling, numpy mirror of hair_derived."""
        pairs = arrays["endpoints"][arrays["endpoint_pairs"]]
        norm = np.linalg.norm(pairs[:, 1] - pairs[:, 0], axis=-1, keepdims=True)
        scale_x = np.clip(norm / 2.0 * self.dist_to_scale_factor, MIN_VAL, None)
        scale_yz = np.exp(np.repeat(arrays["width"], 2, axis=1))
        return np.concatenate([scale_x, scale_yz], axis=1)

    def compute_foreground_mask_np(self, arrays=None):
        if arrays is None:
            arrays = self.host_arrays()
        return (self.np_opacity(arrays)[:, 0] >= OPACITY_TH) & (
            self.np_mask(arrays)[:, 0] >= FG_BIN_TH
        )

    # -- checkpoint I/O --------------------------------------------------

    def capture(self) -> dict:
        """Full optimization state incl. Adam moments, graph and strand
        roots as numpy arrays, keyed (and typed: int32 pairs) as the JAX
        package's save_checkpoint writes them."""
        arrays = self.host_arrays()
        mom = self.host_moments()
        state = {f"param/{k}": v for k, v in arrays.items() if k != "endpoint_pairs"}
        state["endpoint_pairs"] = arrays["endpoint_pairs"].astype(np.int32)
        state.update({f"mu/{k}": v for k, v in mom["mu"].items()})
        state.update({f"nu/{k}": v for k, v in mom["nu"].items()})
        state["step"] = np.asarray(int(self.opt_state.step))
        state["active_sh_degree"] = np.asarray(self.active_sh_degree)
        state["spatial_lr_scale"] = np.asarray(self.spatial_lr_scale)
        state["strand_root_endpoint_idx"] = (
            self.strand_root_endpoint_idx
            if self.strand_root_endpoint_idx is not None
            else np.zeros(0, np.int64)
        )
        state["ref_strand_root"] = (
            self.ref_strand_root if self.ref_strand_root is not None
            else np.zeros((0, 3), np.float32)
        )
        return state

    def save_checkpoint(self, path: str):
        """npz of capture(): goes beyond the reference's PLY checkpoints,
        which restart the optimizer moments on resume (SURVEY §5.4)."""
        import os

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, **self.capture())

    def restore(self, state: dict):
        """Install a capture() dict, this package's or the JAX package's
        save_checkpoint state unchanged: how hair weights come across."""
        from hairgs_tpu_torch.topo.strands import compute_strands_info

        def group(prefix):
            return {k.split("/", 1)[1]: np.array(v) for k, v in state.items()
                    if k.startswith(prefix + "/")}

        seg = group("param")
        endpoints = seg.pop("endpoints")
        self.install(endpoints, np.asarray(state["endpoint_pairs"]), seg,
                     moments={"mu": group("mu"), "nu": group("nu")},
                     step=int(state["step"]))
        self.active_sh_degree = int(state["active_sh_degree"])
        self.spatial_lr_scale = float(state["spatial_lr_scale"])
        self.strand_root_endpoint_idx = np.array(state["strand_root_endpoint_idx"])
        self.ref_strand_root = np.array(state["ref_strand_root"])
        if self.ref_strand_root.shape[0]:
            compute_strands_info(self)

    def load_checkpoint(self, path: str):
        self.restore(dict(np.load(path)))

    def save_ply(self, path: str):
        from hairgs_tpu_torch.io.ply import save_hair_ply

        root_idx = (
            self.strand_root_endpoint_idx
            if self.strand_root_endpoint_idx is not None
            else np.zeros(0, dtype=np.int64)
        )
        ref = self.ref_strand_root if self.ref_strand_root is not None else np.zeros((0, 3))
        save_hair_ply(path, self.host_arrays(), np.asarray(root_idx), np.asarray(ref))

    def load_ply(self, path: str):
        from hairgs_tpu_torch.io.ply import load_hair_ply
        from hairgs_tpu_torch.topo.strands import compute_strands_info

        arrays, root_idx, ref_root = load_hair_ply(path, self.max_sh_degree)
        endpoints = arrays.pop("endpoints")
        pairs = arrays.pop("endpoint_pairs")
        self.install(endpoints, pairs, arrays)
        self.active_sh_degree = self.max_sh_degree
        self.strand_root_endpoint_idx = root_idx
        self.ref_strand_root = ref_root
        compute_strands_info(self)

    def training_setup(self, training_args):
        """hair_gaussian_model.py:212-283 — schedules + max segment length
        from the foreground bounding box."""
        self.training_args = training_args
        self.set_pval(training_args.pval)
        self.merge_dist_th = training_args.merge_dist_th_init
        self.merge_angle_th = training_args.merge_angle_th_init
        arrays = self.host_arrays(
            keys=("endpoints", "endpoint_pairs", "opacity", "mask"))
        fg = self.compute_foreground_mask_np(arrays)
        ep_mask = np.zeros(arrays["endpoints"].shape[0], dtype=bool)
        if fg.any():
            ep_mask[arrays["endpoint_pairs"][fg].ravel()] = True
        else:
            ep_mask[:] = True
        pts = arrays["endpoints"][ep_mask]
        if pts.shape[0] > 0:
            extent = np.linalg.norm(pts.max(axis=0) - pts.min(axis=0))
            self.max_segment_length = float(extent) / training_args.num_points_strand
        if self.opt_state is None and self.params is not None:
            self.opt_state = adam_init(self.params)
