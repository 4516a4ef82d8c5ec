"""Optimization configuration (counterpart of hairgs_tpu/config.py).

The port keeps its own copy of `OptimizationConfig`: field names and
defaults are those of the JAX package, which mirror the reference flag
surface (arguments/__init__.py:55-125).
"""

import dataclasses


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
