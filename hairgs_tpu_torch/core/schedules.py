"""Learning-rate schedules (counterpart of hairgs_tpu/core/schedules.py;
reference utils/general.py:35-68)."""

import math

import torch


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1000000):
    """Log-linear (exponential) decay with optional warm-up, as a float32
    0-d tensor on `step`'s device (the CPU for a Python number). Returns 0
    when both endpoints are 0 and for negative steps."""
    step = torch.as_tensor(step, dtype=torch.float32)
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0, 1)
    log_lerp = torch.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
    lr = delay_rate * log_lerp
    return torch.where(step < 0, torch.zeros_like(lr), lr)


def make_expon_lr_fn(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
                     max_steps=1000000):
    """expon_lr with its schedule bound: a function of the step."""
    def fn(step):
        return expon_lr(step, lr_init, lr_final, lr_delay_steps, lr_delay_mult,
                        max_steps)

    return fn
