"""PyTorch + CUDA port of hairgs_tpu for NVIDIA Hopper (H100).

Module paths and function names mirror `hairgs_tpu`, so each counterpart is
found at the same place. The package imports torch and numpy only; it keeps
its own copies of whatever it needs from the JAX package.

Entry points take an explicit `device`. It defaults to "cuda", and a missing
card raises instead of falling back: only an explicit `device="cpu"` (the
tests) runs on the CPU, where every hand-written kernel is replaced by its
plain PyTorch version.
"""

import torch

# The reference computes in IEEE fp32 everywhere (Precision.HIGHEST in the
# SSIM band matmuls and the compositor contractions). TF32 keeps ~10 mantissa
# bits, which would put ~1e-3 relative error into SSIM and its gradients.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for and
    no card is present (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hairgs_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' explicitly to run the plain "
            "PyTorch versions on the CPU")
    return dev
