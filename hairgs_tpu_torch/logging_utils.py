"""Training telemetry bus + pluggable loggers (counterpart of
hairgs_tpu/logging_utils.py).

Parity target: utils/logging.py — TrainingInfo dataclass (l.11-20) filled by
the train loop and flushed by a Logger selected via --logger
(tensorboard|wandb|none, l.23-29); scalar surface (l.50-95): iteration time,
model size, segment/strand stats, loss terms, densification counters,
per-threshold eval metrics.
"""

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class TrainingInfo:
    iter: int = 0
    # ms the host spent in the iteration's step (the `train/step` span of
    # telemetry.py), logged as general/iter_time: its enqueue, and its waits
    # wherever the step reads from the device; the device may still be
    # running the step when it ends
    elapsed_time: float = 0.0
    loss: Optional[float] = None
    loss_dict: Dict[str, Any] = dataclasses.field(default_factory=dict)
    densification_info: Dict[str, int] = dataclasses.field(default_factory=dict)
    eval_metrics: Optional[Dict[str, np.ndarray]] = None
    eval_thresholds: Optional[List[str]] = None
    train_psnr: Optional[float] = None
    image_metrics: Optional[Dict[str, float]] = None
    composed_image: Optional[np.ndarray] = None
    pred: Optional[Any] = None
    # wall ms of this iteration's topology event, its `topo/event` span
    # (None without one)
    topology_ms: Optional[float] = None
    # whether eval_metrics came from the device (evaluation/device_metrics.py)
    eval_on_device: bool = False


class Logger:
    """Null logger."""

    def log(self, info: TrainingInfo, gaussians=None):
        pass

    def close(self):
        pass


class TensorBoardLogger(Logger):
    """The scalars of utils/logging.py. `general/iter_time` is the host's
    time in the step in ms (TrainingInfo.elapsed_time: its enqueue and its
    in-step waits for the device), not the step's time on the device;
    `densification/t_*` are the topology phases' spans in seconds."""

    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir)

    def log(self, info: TrainingInfo, gaussians=None):
        it = info.iter
        w = self.writer
        w.add_scalar("general/iter_time", info.elapsed_time, it)
        if info.loss is not None:
            w.add_scalar("loss/total", float(info.loss), it)
        for k, v in (info.loss_dict or {}).items():
            w.add_scalar(f"loss/{k}", float(v), it)
        if gaussians is not None:
            from hairgs_tpu_torch.models.hair import HairModel

            if isinstance(gaussians, HairModel):
                w.add_scalar("general/num_segments", gaussians.num_segments, it)
                w.add_scalar("general/num_endpoints", gaussians.num_endpoints, it)
                if gaussians.strands_info is not None:
                    strands = gaussians.strands_info.list_strands
                    w.add_scalar("general/num_strands", len(strands), it)
                    if strands:
                        lengths = [s.shape[0] for s in strands]
                        w.add_scalar("general/avg_strand_segments",
                                     float(np.mean(lengths)), it)
            else:
                w.add_scalar("general/num_gaussians", gaussians.count, it)
        for k, v in (info.densification_info or {}).items():
            w.add_scalar(f"densification/{k}", v, it)
        if info.eval_metrics is not None and info.eval_thresholds is not None:
            for name, values in info.eval_metrics.items():
                for th, value in zip(info.eval_thresholds, values):
                    w.add_scalar(f"eval/{name}@{th}", float(value), it)
        if info.train_psnr is not None:
            w.add_scalar("general/train_psnr", float(info.train_psnr), it)
        for k, v in (info.image_metrics or {}).items():
            w.add_scalar(f"eval/{k}", float(v), it)
        if info.composed_image is not None:
            w.add_image("render/grid", info.composed_image, it, dataformats="HWC")

    def close(self):
        self.writer.close()


class WandbLogger(Logger):
    def __init__(self, project: str, run_dir: str):
        import wandb  # optional dependency; gated

        self.wandb = wandb
        wandb.init(project=project, dir=run_dir)

    def log(self, info: TrainingInfo, gaussians=None):
        payload = {"general/iter_time": info.elapsed_time}
        if info.loss is not None:
            payload["loss/total"] = float(info.loss)
        for k, v in (info.loss_dict or {}).items():
            payload[f"loss/{k}"] = float(v)
        for k, v in (info.densification_info or {}).items():
            payload[f"densification/{k}"] = v
        if info.eval_metrics is not None and info.eval_thresholds is not None:
            for name, values in info.eval_metrics.items():
                for th, value in zip(info.eval_thresholds, values):
                    payload[f"eval/{name}@{th}"] = float(value)
        if info.train_psnr is not None:
            payload["general/train_psnr"] = float(info.train_psnr)
        for k, v in (info.image_metrics or {}).items():
            payload[f"eval/{k}"] = float(v)
        self.wandb.log(payload, step=info.iter)


def get_logger(args) -> Logger:
    """utils/logging.py:23-29."""
    kind = getattr(args, "logger", "none") or "none"
    if kind == "tensorboard":
        try:
            return TensorBoardLogger(args.model_path)
        except ImportError:
            print("[logger] tensorboard unavailable; falling back to null logger")
            return Logger()
    if kind == "wandb":
        try:
            return WandbLogger("hairgs_tpu_torch", args.model_path)
        except ImportError:
            print("[logger] wandb unavailable; falling back to null logger")
            return Logger()
    return Logger()
