"""Configuration dataclasses + CLI plumbing (counterpart of
hairgs_tpu/config.py).

Field names and defaults are those of the JAX package, which mirror the
reference flag surface (arguments/__init__.py:55-125), so command lines
transfer 1:1. Two defaults differ, each documented at its field:
`ModelConfig.data_device` ("cuda", the device the driver runs on) and the
meaning of `RuntimeConfig.use_pallas="auto"`. `cfg_args` persistence follows
utils/system.py:41-54 / arguments/__init__.py:128-148.
"""

import dataclasses
import os
from argparse import ArgumentParser, BooleanOptionalAction, Namespace
from typing import Optional


@dataclasses.dataclass
class ModelConfig:
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    sh_degree: int = 0  # reference default 0 (arguments/__init__.py:60)
    resolution: int = -1
    data_device: str = "cuda"  # the device the driver trains on ("cuda"
    # or "cpu"); the JAX package's "tpu" names its default device instead
    eval: bool = False


@dataclasses.dataclass
class OptimizationConfig:
    # Common (arguments/__init__.py:72-111)
    iterations: int = 30000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30000
    scaling_lr: float = 0.005
    feature_lr: float = 0.025
    opacity_lr: float = 0.05
    mask_lr: float = 0.01
    lambda_dssim: float = 0.2
    lambda_orientation: float = 100.0
    lambda_mask: float = 0.01
    pval: float = 0.05
    bidirectional_eval: bool = True
    # GS specific
    rotation_lr: float = 0.001
    # Hair-GS specific
    lambda_smooth: float = 0.005
    lambda_magnet: float = 0.0
    bidirectional_merge: bool = False
    num_points_strand: int = 80
    merge_interval: int = 100
    merge_dist_th_init: float = 2e-3
    merge_dist_th_final: float = 4e-3
    merge_angle_th_init: float = 20.0
    merge_angle_th_final: float = 40.0
    growth_interval: int = 100000
    growth_averaging_points: int = 3
    growth_length: float = 0.002  # per-event tip extension (meters)
    growth_max_events: int = 0  # 0 = unlimited
    # Densification
    percent_dense: float = 0.01
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 27000  # iterations * 0.9
    densification_interval: int = 100
    prune_max_radii_2d: int = 1000
    densify_grad_threshold: float = 0.0002


@dataclasses.dataclass
class GeneralConfig:
    quiet: bool = False
    logger: str = "tensorboard"
    ip: str = "127.0.0.1"
    port: int = 6009
    vis2d: bool = False
    update_vis2d_frequency: int = 30000
    vis3d: bool = False
    save_frequency: int = 5000
    eval_frequency: int = 30000


@dataclasses.dataclass
class RuntimeConfig:
    """Runtime knobs with no reference equivalent (the JAX package's)."""

    view_batch: int = 1  # cameras per step, averaged into one Adam step
    mesh_max_devices: int = 0  # cap on the view-parallel device count
    # (views run on one card until parallel/ is ported, ROADMAP Queue 1 item 9)
    gauss_shard: int = 1  # >1: depth-slab shard the Gaussian axis (not
    # ported: ROADMAP Queue 1 item 9)
    max_tiles_per_gaussian: int = 16
    freeze_tile_budget: bool = False  # pin max_tiles_per_gaussian and
    # max_pairs_per_tile (disable their adaptive controllers)
    max_pairs_per_tile: int = 2048
    composite_chunk: int = 128
    pair_capacity: int = 0  # compact paged pair-table size in slots. 0 =
    # adaptive (the driver starts near the measured demand and re-buckets);
    # -1 = worst-case n*max_tiles sizing (never capacity-truncates); >0 =
    # fixed slot count (rounded up to the chunk)
    pair_capacity_round: int = 131072  # adaptive pair-capacity bucket granule
    dma_lookahead: bool = True  # schedules the TPU kernels' cross-tile DMA
    # prefetch and is bit-identical in JAX; accepted and changes nothing here
    capacity_round: int = 4096
    use_pallas: str = "auto"  # auto: the compositor kernels (the paged
    # path) when the driver's device is CUDA, the XLA path elsewhere
    feat_bf16: bool = False  # bf16 feature plane in the pair table (feature
    # values and gradients round to bf16, geometry stays f32)
    antialiasing: bool = False  # Mip-Splatting dilation compensation: scale
    # opacity by sqrt(det(cov)/det(cov+0.3I)) (opt-in; the reference keeps
    # the +0.3px low-pass uncompensated)
    alpha_min: float = 1.0 / 255.0  # per-pair alpha gate (reference value
    # 1/255, forward.cu:343-351); splats below it get zero gradient
    device_eval: str = "auto"  # auto: in-training metrics on the host;
    # "true" needs evaluation/device_metrics.py (ROADMAP Queue 1 item 7)
    log_interval: int = 10  # scalar-logging/sync cadence (the reference
    # syncs every iteration via loss.item(), train.py:160)
    profile_steps: int = 0  # >0: write a torch.profiler trace of these steps
    debug: bool = False  # dump the state on a non-finite loss
    async_topology: bool = False  # hair models only (ROADMAP Queue 1 item 6)


_SHORTHANDS = {"source_path": "s", "model_path": "m", "images": "i", "resolution": "r"}
_HELP = {
    "dma_lookahead": "accepted for command-line parity and ignored: it "
                     "schedules the TPU kernels' cross-tile DMA prefetch, "
                     "bit-identical in JAX, and the CUDA kernels have no "
                     "such schedule",
}


def add_config_args(parser: ArgumentParser, cls, defaults=None) -> None:
    inst = defaults if defaults is not None else cls()
    for f in dataclasses.fields(cls):
        value = getattr(inst, f.name)
        names = ["--" + f.name]
        if f.name in _SHORTHANDS:
            names.append("-" + _SHORTHANDS[f.name])
        if f.type is bool or isinstance(value, bool):
            # BooleanOptionalAction so default-True flags (bidirectional_eval)
            # get a working --no-X form
            parser.add_argument(*names, default=value, action=BooleanOptionalAction,
                                help=_HELP.get(f.name))
        else:
            parser.add_argument(*names, default=value, type=type(value),
                                help=_HELP.get(f.name))


def extract_config(args: Namespace, cls):
    kwargs = {
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(cls)
        if hasattr(args, f.name)
    }
    return cls(**kwargs)


def save_cfg_args(model_path: str, args: Namespace) -> None:
    """Persist flags as a Namespace repr, reference utils/system.py:53-54."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(repr(args))


def load_cfg_args(model_path: str) -> Optional[Namespace]:
    path = os.path.join(model_path, "cfg_args")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        text = f.read()
    return eval(text, {"Namespace": Namespace})  # noqa: S307 - same as reference


def get_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """Merge stored cfg_args with CLI overrides (arguments/__init__.py:128-148)."""
    args_cmdline = parser.parse_args(argv)
    stored = None
    if getattr(args_cmdline, "model_path", None):
        stored = load_cfg_args(args_cmdline.model_path)
    merged = vars(stored).copy() if stored is not None else {}
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return Namespace(**merged)
