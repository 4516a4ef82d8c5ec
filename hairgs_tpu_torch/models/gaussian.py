"""Stage-I Gaussian point model on capacity-padded arenas (counterpart of
hairgs_tpu/models/gaussian.py).

Parity target: reference scene/gaussian_model.py (GaussianModel) —
parameters xyz / features_dc / features_rest / scaling(log) / rotation(quat
wxyz) / opacity(logit) / mask(logit), activations, per-group Adam, densify
clone/split/prune (l.544-673), opacity reset (l.414-419) and segment-endpoint
extraction (l.706-725).

As in the JAX package, parameters and Adam moments live in fixed-capacity
arenas with an `active` row mask, so the train step sees the same shapes
between topology events. Topology ops run on the host (numpy) at the
reference's cadence on the live rows pulled with `.cpu()`, then write back
into a (possibly re-bucketed) arena; the Adam moments never leave the
device: surgery is a gather-or-zero index map applied there.
"""

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from hairgs_tpu_torch import resolve_device
from hairgs_tpu_torch.core.camera import Camera
from hairgs_tpu_torch.core.maths import (
    dist_to_scale_factor_to_pval,
    pval_to_dist_to_scale_factor,
    safe_norm,
)
from hairgs_tpu_torch.core.sh import RGB2SH
from hairgs_tpu_torch.core.transforms import build_rotation
from hairgs_tpu_torch.optim import AdamState, adam_init

OPACITY_TH = 0.005  # scene/gaussian_model.py:37
FG_BIN_TH = 0.25  # scene/gaussian_model.py:38 foreground_binarization_th

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


def _round_capacity(n: int, bucket: int) -> int:
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def _pad_to(arr: np.ndarray, capacity: int) -> np.ndarray:
    pad = capacity - arr.shape[0]
    if pad == 0:
        return arr
    return np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], dtype=arr.dtype)], axis=0)


def _host(t: torch.Tensor, count: int) -> np.ndarray:
    """The first `count` rows as a numpy array that owns its memory."""
    return t[:count].detach().to("cpu", copy=True).numpy()


def _rotations_np(quats: np.ndarray) -> np.ndarray:
    return build_rotation(torch.from_numpy(np.ascontiguousarray(quats))).numpy()


@dataclasses.dataclass
class GaussianModel:
    """Host-side wrapper orchestrating the padded device state, with the
    JAX package's API; the train loop consumes `.params/.active/.stats/
    .opt_state` directly. Every tensor lives on `device` ("cuda" unless
    the caller asks for the CPU)."""

    sh_degree: int = 3
    spatial_lr_scale: float = 1.0
    capacity_round: int = 4096
    device: str = "cuda"

    params: Optional[GaussianParams] = None
    active: Optional[torch.Tensor] = None
    stats: Optional[GaussianStats] = None
    opt_state: Optional[AdamState] = None
    count: int = 0
    active_sh_degree: int = 0
    pval: float = 0.05
    dist_to_scale_factor: float = pval_to_dist_to_scale_factor(0.05)
    training_args: Optional[object] = None
    # the split sampler, one stream per model as in JAX: the same state
    # draws the same children in both packages
    _rng: np.random.Generator = dataclasses.field(
        default_factory=lambda: np.random.default_rng(0)
    )

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # -- setup -----------------------------------------------------------

    @property
    def max_sh_degree(self) -> int:
        return self.sh_degree

    @property
    def capacity(self) -> int:
        return 0 if self.params is None else self.params.xyz.shape[0]

    def set_pval(self, pval: float):
        self.pval = pval
        self.dist_to_scale_factor = pval_to_dist_to_scale_factor(pval)

    def set_dist_to_scale_factor(self, factor: float):
        self.dist_to_scale_factor = factor
        self.pval = dist_to_scale_factor_to_pval(factor)

    def oneup_sh_degree(self):
        if self.active_sh_degree < self.max_sh_degree:
            self.active_sh_degree += 1

    def create_from_pcd(self, points: np.ndarray, colors: np.ndarray):
        """Initialize from a point cloud; scene/gaussian_model.py:163-208.

        Initial scale = log(sqrt(mean squared distance to 3-NN)) replicated on
        all axes (the kNN runs on the model's device); opacity 0.1, mask 0.5,
        identity rotation."""
        from hairgs_tpu_torch.ops.knn import mean_sq_dist_3nn

        n = points.shape[0]
        pts = torch.tensor(np.asarray(points, np.float32), device=self.device)
        dist2 = mean_sq_dist_3nn(pts).cpu().numpy()
        dist2 = np.maximum(dist2, 1e-7)
        scales = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1).astype(np.float32)
        rots = np.zeros((n, 4), dtype=np.float32)
        rots[:, 0] = 1.0
        num_coeffs = (self.max_sh_degree + 1) ** 2
        f_dc = RGB2SH(np.asarray(colors, dtype=np.float32))[:, None, :]
        f_rest = np.zeros((n, num_coeffs - 1, 3), dtype=np.float32)
        inv_sig = lambda x: math.log(x / (1 - x))
        arrays = dict(
            xyz=np.asarray(points, dtype=np.float32),
            features_dc=np.asarray(f_dc, dtype=np.float32),
            features_rest=f_rest,
            scaling=scales,
            rotation=rots,
            opacity=np.full((n, 1), inv_sig(0.1), dtype=np.float32),
            mask=np.full((n, 1), inv_sig(0.5), dtype=np.float32),
        )
        self._install(arrays, n)

    def _install(self, arrays: dict, count: int, moments: Optional[dict] = None,
                 step: int = 0, moment_maps=None):
        """Write host arrays into a (re)padded device arena.

        moment_maps: (src, zero_planes), a gather-or-zero map into the
        CURRENT opt_state rows (-1 = zero-init), applied on the device."""
        cap = _round_capacity(count, self.capacity_round)
        dev = self.device

        remapped = None
        if moment_maps is not None and self.opt_state is not None:
            src, zero_planes = moment_maps
            src_cap = np.full(cap, -1, np.int64)
            src_cap[: src.shape[0]] = src
            idx = torch.tensor(np.clip(src_cap, 0, None), device=dev)
            live = torch.tensor(src_cap >= 0, device=dev)

            def take(name, arr):
                if name in zero_planes:
                    return torch.zeros((cap,) + tuple(arr.shape[1:]),
                                       dtype=arr.dtype, device=dev)
                g = arr[idx]
                return torch.where(live.reshape((-1,) + (1,) * (g.ndim - 1)),
                                   g, torch.zeros_like(g))

            def remap_tree(tree):
                return GaussianParams(
                    **{k: take(k, v) for k, v in tree._asdict().items()})

            remapped = AdamState(
                mu=remap_tree(self.opt_state.mu),
                nu=remap_tree(self.opt_state.nu),
                step=torch.tensor(step, dtype=torch.int32, device=dev),
            )

        def arena(host):
            return GaussianParams(**{
                k: torch.tensor(_pad_to(np.asarray(host[k]), cap), device=dev)
                for k in GaussianParams._fields})

        self.params = arena(arrays)
        self.active = torch.arange(cap, device=dev) < count
        self.count = count
        self.stats = GaussianStats(
            max_radii2d=torch.zeros((cap,), dtype=torch.float32, device=dev),
            xyz_grad_accum=torch.zeros((cap, 1), dtype=torch.float32, device=dev),
            denom=torch.zeros((cap, 1), dtype=torch.float32, device=dev),
        )
        if remapped is not None:
            self.opt_state = remapped
        elif moments is None:
            self.opt_state = adam_init(self.params)
        else:
            self.opt_state = AdamState(
                mu=arena(moments["mu"]), nu=arena(moments["nu"]),
                step=torch.tensor(step, dtype=torch.int32, device=dev))

    def training_setup(self, training_args):
        self.training_args = training_args
        self.set_pval(training_args.pval)
        if self.opt_state is None and self.params is not None:
            self.opt_state = adam_init(self.params)

    # -- host-side views -------------------------------------------------

    def host_arrays(self) -> dict:
        """The live rows of every parameter as numpy arrays (pad rows stay
        on the device)."""
        return {k: _host(v, self.count) for k, v in self.params._asdict().items()}

    def host_moments(self) -> dict:
        return {g: {k: _host(v, self.count) for k, v in
                    getattr(self.opt_state, g)._asdict().items()}
                for g in ("mu", "nu")}

    # convenience numpy activations (host-side topology code)
    def np_scaling(self, arrays):
        return np.exp(arrays["scaling"])

    def np_opacity(self, arrays):
        return 1.0 / (1.0 + np.exp(-arrays["opacity"]))

    def np_mask(self, arrays):
        return 1.0 / (1.0 + np.exp(-arrays["mask"]))

    # -- topology ops (host-side, reference semantics) -------------------

    def reset_opacity(self):
        """opacity <- inverse_sigmoid(min(opacity, 0.01)), moments zeroed
        (scene/gaussian_model.py:414-419)."""
        arrays = self.host_arrays()
        opa = self.np_opacity(arrays)
        new = np.log(np.minimum(opa, 0.01) / (1 - np.minimum(opa, 0.01)))
        arrays["opacity"] = new.astype(np.float32)
        step = int(self.opt_state.step)
        self._install(arrays, self.count, step=step,
                      moment_maps=(np.arange(self.count), frozenset({"opacity"})))

    def densification(self, extent: float, max_screen_size, training_info=None):
        """Clone + split + prune; scene/gaussian_model.py:636-673.

        Stats (grad accum / denom / max_radii2d) are read before and reset to
        zero after, exactly as densification_postfix does (l.538-542)."""
        arrays = self.host_arrays()
        # moments stay on device: surgery is tracked as a gather-or-zero
        # index map and applied by _install
        src = np.arange(self.count, dtype=np.int64)
        stats_np = {k: _host(v, self.count) for k, v in self.stats._asdict().items()}
        ta = self.training_args
        with np.errstate(divide="ignore", invalid="ignore"):
            grads = stats_np["xyz_grad_accum"] / stats_np["denom"]
        grads = np.nan_to_num(grads, nan=0.0)
        max_grad = ta.densify_grad_threshold
        split_threshold = ta.percent_dense * extent

        info = {}

        def cat(arrays, src, sel):
            new = {k: np.concatenate([v, v[sel]], axis=0) for k, v in arrays.items()}
            src = np.concatenate([src, np.full(int(sel.sum()), -1, np.int64)])
            return new, src

        # --- clone (l.602-634): small gaussians with large view grad
        scaling = self.np_scaling(arrays)
        sel = (np.linalg.norm(grads, axis=-1) >= max_grad) & (
            scaling.max(axis=1) <= split_threshold
        )
        info["clone"] = int(sel.sum())
        arrays, src = cat(arrays, src, sel)

        # --- split (l.544-600): large gaussians; sample N=2 from the pdf
        n_now = arrays["xyz"].shape[0]
        padded_grad = np.zeros(n_now, dtype=np.float32)
        padded_grad[: grads.shape[0]] = grads.squeeze(-1)
        scaling = self.np_scaling(arrays)
        sel = (padded_grad >= max_grad) & (scaling.max(axis=1) > split_threshold)
        n_split = int(sel.sum())
        info["split"] = n_split
        if n_split > 0:
            N = 2
            stds = np.tile(scaling[sel], (N, 1))
            samples = self._rng.normal(0.0, stds).astype(np.float32)
            rots = np.tile(_rotations_np(arrays["rotation"][sel]), (N, 1, 1))
            new_xyz = np.einsum("nij,nj->ni", rots, samples) + np.tile(
                arrays["xyz"][sel], (N, 1)
            )
            new_scaling = np.log(np.tile(scaling[sel], (N, 1)) / (0.8 * N)).astype(
                np.float32
            )
            add = {
                "xyz": new_xyz.astype(np.float32),
                "scaling": new_scaling,
                "rotation": np.tile(arrays["rotation"][sel], (N, 1)),
                "features_dc": np.tile(arrays["features_dc"][sel], (N, 1, 1)),
                "features_rest": np.tile(arrays["features_rest"][sel], (N, 1, 1)),
                "opacity": np.tile(arrays["opacity"][sel], (N, 1)),
                "mask": np.tile(arrays["mask"][sel], (N, 1)),
            }
            arrays = {k: np.concatenate([v, add[k]], axis=0) for k, v in arrays.items()}
            src = np.concatenate([src, np.full(new_xyz.shape[0], -1, np.int64)])
            keep = np.ones(arrays["xyz"].shape[0], dtype=bool)
            keep[:n_now][sel] = False  # prune split originals
            arrays = {k: v[keep] for k, v in arrays.items()}
            src = src[keep]

        # --- prune (l.646-670)
        opa = self.np_opacity(arrays)[:, 0]
        prune = opa < OPACITY_TH
        info["prune_low_opacity"] = int(prune.sum())
        if max_screen_size:
            # the reference's screen-radius test only sees radii that its
            # clone/split postfix has just zeroed: the world-space test alone
            # has the same effect
            scaling = self.np_scaling(arrays)
            big_ws = scaling.max(axis=1) > 0.1 * extent
            info["prune_big_ws"] = int(big_ws.sum())
            prune = prune | big_ws
        info["prune_total"] = int(prune.sum())
        if prune.sum() != arrays["xyz"].shape[0]:
            keep = ~prune
            arrays = {k: v[keep] for k, v in arrays.items()}
            src = src[keep]

        if training_info is not None:
            training_info.densification_info.update(info)
        self._install(arrays, arrays["xyz"].shape[0],
                      step=int(self.opt_state.step),
                      moment_maps=(src, frozenset()))
        return info

    # -- checkpoint I/O --------------------------------------------------

    def save_ply(self, path: str):
        from hairgs_tpu_torch.io.ply import save_gaussian_ply

        save_gaussian_ply(path, self.host_arrays())

    def load_ply(self, path: str):
        from hairgs_tpu_torch.io.ply import load_gaussian_ply

        arrays = load_gaussian_ply(path, self.max_sh_degree)
        self._install(arrays, arrays["xyz"].shape[0])
        self.active_sh_degree = self.max_sh_degree

    # -- conversion ------------------------------------------------------

    def to_hair_model(self, ref_strand_root: np.ndarray):
        """Convert to a HairModel on the same device: each Gaussian becomes a
        disconnected line segment (scene/gaussian_model.py:797-859). Width =
        mean of the two minor scales (log space); endpoint_pairs =
        [(i, i+N)]."""
        from hairgs_tpu_torch.models.hair import HairModel
        from hairgs_tpu_torch.topo.strands import (
            compute_strands_info,
            update_strand_root,
        )

        arrays = self.host_arrays()
        n = arrays["xyz"].shape[0]
        endpoints2 = self.get_segment_endpoints_np(arrays)  # (N,2,3)
        endpoints = np.concatenate([endpoints2[:, 0], endpoints2[:, 1]], axis=0)
        scale = self.np_scaling(arrays)
        axis_idx = np.argmax(scale, axis=1)
        other = np.ones_like(scale)
        other[np.arange(n), axis_idx] = 0
        width = np.mean(scale * other, axis=1, keepdims=True)
        width = np.log(np.maximum(width, 1e-12)).astype(np.float32)
        pairs = np.stack([np.arange(n), np.arange(n) + n], axis=1)

        hair = HairModel(
            sh_degree=self.max_sh_degree,
            spatial_lr_scale=self.spatial_lr_scale,
            capacity_round=self.capacity_round,
            device=self.device,
        )
        hair.set_dist_to_scale_factor(float(self.dist_to_scale_factor))
        hair.active_sh_degree = self.active_sh_degree
        hair.install(
            endpoints,
            pairs,
            dict(
                features_dc=arrays["features_dc"],
                features_rest=arrays["features_rest"],
                opacity=arrays["opacity"],
                mask=arrays["mask"],
                width=width,
            ),
        )
        hair.ref_strand_root = ref_strand_root
        update_strand_root(hair)
        compute_strands_info(hair)
        if self.training_args is not None:
            hair.training_setup(self.training_args)
        return hair

    def get_segment_endpoints_np(self, arrays=None) -> np.ndarray:
        """(N,2,3) endpoints mu +- R (argmax-scale axis * sigma / factor);
        scene/gaussian_model.py:706-725."""
        if arrays is None:
            arrays = self.host_arrays()
        scale = self.np_scaling(arrays)
        axis_idx = np.argmax(scale, axis=1)
        main_axis = np.zeros_like(scale)
        main_axis[np.arange(scale.shape[0]), axis_idx] = 1.0
        dist = main_axis * scale * (1.0 / self.dist_to_scale_factor)
        rotated = np.einsum("nij,nj->ni", _rotations_np(arrays["rotation"]), dist)
        center = arrays["xyz"]
        return np.stack([center + rotated, center - rotated], axis=1)

    def compute_foreground_mask_np(self, arrays=None, lines_only: bool = False) -> np.ndarray:
        """opacity >= th AND mask >= binarization th; with lines_only, keep
        only gaussians elongated along exactly one axis with thin round minor
        axes (scene/gaussian_model.py:727-795)."""
        if arrays is None:
            arrays = self.host_arrays()
        mask = (self.np_opacity(arrays)[:, 0] >= OPACITY_TH) & (
            self.np_mask(arrays)[:, 0] >= FG_BIN_TH
        )
        if lines_only:
            factor_threshold = 5
            eps = 1e-1
            radius_threshold = 2.5e-5
            s = self.np_scaling(arrays)
            scale_th = radius_threshold * self.dist_to_scale_factor

            def line_along(i, j, k):
                # axis i dominant; j,k similar and thin
                cond = (s[:, i] / s[:, j] > factor_threshold) & (
                    s[:, i] / s[:, k] > factor_threshold
                )
                ratio = s[:, j] / s[:, k]
                # reference l.745-751: the or-clause is a tautology as written;
                # replicated faithfully (any ratio passes)
                cond &= (ratio > 1 - eps) | (ratio < 1 + eps)
                cond &= (s[:, j] <= scale_th) & (s[:, k] <= scale_th)
                return cond

            x_line = line_along(0, 1, 2)
            y_line = line_along(1, 0, 2)
            z_line = line_along(2, 0, 1)
            mask &= x_line ^ y_line ^ z_line
        return mask

    # -- full-state checkpointing (capture/restore) ----------------------

    def capture(self) -> dict:
        """Full optimization state incl. Adam moments, as numpy arrays keyed
        as the JAX package's capture() keys them."""
        c = self.count
        state = {f"param/{k}": _host(v, c) for k, v in self.params._asdict().items()}
        for g in ("mu", "nu"):
            state.update({f"{g}/{k}": _host(v, c) for k, v in
                          getattr(self.opt_state, g)._asdict().items()})
        state["step"] = np.asarray(int(self.opt_state.step))
        state["active_sh_degree"] = np.asarray(self.active_sh_degree)
        state["spatial_lr_scale"] = np.asarray(self.spatial_lr_scale)
        state.update({f"stats/{k}": _host(v, c) for k, v in self.stats._asdict().items()})
        return state

    def save_checkpoint(self, path: str):
        import os

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, **self.capture())

    def restore(self, state: dict):
        """Install a capture() dict, this package's or the JAX package's
        unchanged: how weights come across from JAX."""
        def group(prefix):
            return {k.split("/", 1)[1]: np.array(v) for k, v in state.items()
                    if k.startswith(prefix + "/")}

        params = group("param")
        self._install(params, params["xyz"].shape[0],
                      moments={"mu": group("mu"), "nu": group("nu")},
                      step=int(state["step"]))
        self.active_sh_degree = int(state["active_sh_degree"])
        self.spatial_lr_scale = float(state["spatial_lr_scale"])
        stats = group("stats")
        self.stats = GaussianStats(**{
            k: torch.tensor(_pad_to(stats[k], self.capacity), device=self.device)
            for k in GaussianStats._fields})

    def load_checkpoint(self, path: str):
        self.restore(dict(np.load(path)))

    def clean_gaussians(self):
        arrays = self.host_arrays()
        keep = self.compute_foreground_mask_np(arrays)
        arrays = {k: v[keep] for k, v in arrays.items()}
        src = np.arange(self.count, dtype=np.int64)[keep]
        self._install(arrays, arrays["xyz"].shape[0],
                      step=int(self.opt_state.step),
                      moment_maps=(src, frozenset()))
