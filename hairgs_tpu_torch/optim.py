"""Per-group Adam over capacity-padded parameter arenas (counterpart of
hairgs_tpu/optim.py): torch.optim.Adam semantics with eps 1e-15 and betas
(0.9, 0.999), one learning rate per parameter group. The moments are plain
tensors beside the parameters, so topology surgery can address rows."""

from typing import Any, NamedTuple

import torch


class AdamState(NamedTuple):
    mu: Any  # NamedTuple of tensors like params
    nu: Any
    step: torch.Tensor  # () int32


def adam_init(params) -> AdamState:
    zeros = type(params)(*[torch.zeros_like(p) for p in params])
    zeros2 = type(params)(*[torch.zeros_like(p) for p in params])
    device = params[0].device
    return AdamState(mu=zeros, nu=zeros2,
                     step=torch.zeros((), dtype=torch.int32, device=device))


def adam_step(params, grads, state: AdamState, lr_tree, b1=0.9, b2=0.999,
              eps=1e-15, out=None):
    """One Adam update; lr_tree has params' structure with scalar leaves
    (Python floats or 0-d tensors). Returns new (params, state). With `out`
    = (params, state) of tensors (the inputs themselves may be given), the
    results are written into those by the same operations, bit for bit."""
    none = (None,) * len(params)
    o_params, o_state = out if out is not None else (none, AdamState(none, none, None))
    step = torch.add(state.step, 1, out=o_state.step)
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, stepf)
    c2 = 1.0 - torch.pow(b2, stepf)
    new_mu = [torch.add(b1 * m, (1 - b1) * g, out=o)
              for g, m, o in zip(grads, state.mu, o_state.mu)]
    new_nu = [torch.add(b2 * v, (1 - b2) * g * g, out=o)
              for g, v, o in zip(grads, state.nu, o_state.nu)]
    new_params = [torch.sub(p, lr * (m / c1) / (torch.sqrt(v / c2) + eps), out=o)
                  for p, m, v, lr, o in zip(params, new_mu, new_nu, lr_tree, o_params)]
    cls = type(params)
    return cls(*new_params), AdamState(mu=cls(*new_mu), nu=cls(*new_nu), step=step)
