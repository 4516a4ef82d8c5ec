"""Precision probe of the card (counterpart of
scripts/mosaic_precision_probe.py).

On the script's inputs (the same draws from np.random.default_rng(0), in
the same order) one hand-written kernel (csrc/precision_probe.cu) computes
four outputs: A.B in full fp32 (the counterpart of Precision.HIGHEST), A.B
on TF32 tensor cores (what DEFAULT precision means for an fp32 product on
this card, and what torch.backends.cuda.matmul.allow_tf32=True gives),
expf(x) and log1pf(-al). The script's "XLA" side becomes the library calls
on the card: torch.matmul with TF32 off and on, torch.exp and torch.log1p.
Each is held against float64 on the host, and the kernel's exp and log1p
against torch's bit for bit: the compositor kernels' tight gates rest on
their expf rounding like torch.exp.

    python3 -m hairgs_tpu_torch.probes.precision_probe [--device cpu]

On the card by default; `--device cpu` runs the plain versions instead of
the kernel (and torch's CPU matmul, which has no TF32).
"""

import argparse
import contextlib
import ctypes

import numpy as np
import torch

from hairgs_tpu_torch import kernels, resolve_device

# launches of the hand-written kernel; the wrapper adds one where it launches
launches = {"precision_probe": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def probe_inputs():
    """The script's draws (mosaic_precision_probe.py:34-39): log1p(-alpha)
    magnitudes, a 0/1 matrix, exponents and alphas, as float32 numpy."""
    rng = np.random.default_rng(0)
    A = rng.uniform(-0.05, 0.0, (256, 128)).astype(np.float32)
    B = (rng.uniform(0, 1, (128, 128)) < 0.5).astype(np.float32)
    x = rng.uniform(-9.0, 0.0, (8, 128)).astype(np.float32)
    al = rng.uniform(0.0, 0.99, (8, 128)).astype(np.float32)
    return A, B, x, al


def round_to_tf32(t):
    """float32 -> the nearest TF32 value as float32, as `cvt.rna.tf32.f32`
    rounds: keep 10 mantissa bits, round to nearest with ties away from
    zero (add half of the 13 dropped bits to the magnitude, then clear
    them). A carry past the largest finite value gives inf; inf stays inf
    and NaN stays NaN."""
    bits = t.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(t), t, rounded)


@contextlib.contextmanager
def _tf32_matmul(enabled: bool):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def probe_plain(A, B, x, al):
    """Plain PyTorch version of the kernel: (A.B fp32, A.B from
    TF32-rounded operands with an fp32 product, exp(x), log1p(-al))."""
    with _tf32_matmul(False):
        hi = A @ B
        tf32 = round_to_tf32(A) @ round_to_tf32(B)
    return hi, tf32, torch.exp(x), torch.log1p(-al)


def _check(t, name, shape):
    if t.device.type != "cuda" or t.dtype != torch.float32 \
            or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected a contiguous float32 CUDA tensor "
                         f"of shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def probe_cuda(A, B, x, al):
    """Launches csrc/precision_probe.cu; same contract as probe_plain."""
    m, k = A.shape
    n = B.shape[1]
    _check(A, "A", (m, k))
    _check(B, "B", (k, n))
    _check(x, "x", x.shape)
    _check(al, "al", x.shape)
    if m % 16 or n % 8 or k % 8:
        raise ValueError(f"the probe kernel takes M % 16 == N % 8 == K % 8 "
                         f"== 0, got {(m, n, k)}")
    fn = kernels.load("precision_probe").precision_probe
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    outs = (torch.empty((m, n), dtype=torch.float32, device=A.device),
            torch.empty((m, n), dtype=torch.float32, device=A.device),
            torch.empty_like(x), torch.empty_like(al))
    err = fn(A.data_ptr(), B.data_ptr(), x.data_ptr(), al.data_ptr(),
             *(o.data_ptr() for o in outs), m, n, k, x.numel(),
             torch.cuda.current_stream(A.device).cuda_stream)
    if err:
        raise RuntimeError(f"precision_probe launch failed: CUDA error {err}")
    launches["precision_probe"] += 1
    return outs


def probe(A, B, x, al):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if A.device.type == "cuda":
        return probe_cuda(A, B, x, al)
    if A.device.type == "cpu":
        return probe_plain(A, B, x, al)
    raise ValueError(f"no precision probe for device {A.device}")


def library_outputs(A, B, x, al):
    """The library calls of the same four functions: torch.matmul with TF32
    off and on, torch.exp, torch.log1p."""
    with _tf32_matmul(False):
        hi = torch.matmul(A, B)
    with _tf32_matmul(True):
        tf32 = torch.matmul(A, B)
    return hi, tf32, torch.exp(x), torch.log1p(-al)


def rel(a, g):
    """Largest elementwise relative error of a against the f64 truth g."""
    return float(np.max(np.abs(a - g) / (np.abs(g) + 1e-30)))


def run_probe(device):
    """Runs the probe on `device`; returns the four kernel (or, on the CPU,
    plain) outputs, the four library outputs and the f64 truths, as numpy,
    and the report of the script's four lines."""
    A, B, x, al = probe_inputs()
    dev = resolve_device(device)
    t = [torch.tensor(a, device=dev) for a in (A, B, x, al)]
    k_out = [o.cpu().numpy() for o in probe(*t)]
    l_out = [o.cpu().numpy() for o in library_outputs(*t)]
    truth = [A.astype(np.float64) @ B.astype(np.float64),
             np.exp(x.astype(np.float64)), np.log1p(-al.astype(np.float64))]
    return k_out, l_out, truth, report(k_out, l_out, truth)


def report(k_out, l_out, truth):
    """The script's four lines (mosaic_precision_probe.py:83-94), `kernel`
    for `pallas` and `torch` for `xla`; DEFAULT is the TF32 product."""
    (k_hi, k_def, k_exp, k_l1p), (t_hi, t_def, t_exp, t_l1p) = k_out, l_out
    g_dot, g_exp, g_l1p = truth
    return [
        f"dot rel-vs-f64: kernel HIGHEST={rel(k_hi, g_dot):.2e} "
        f"kernel DEFAULT={rel(k_def, g_dot):.2e} "
        f"torch HIGHEST={rel(t_hi, g_dot):.2e} "
        f"torch DEFAULT={rel(t_def, g_dot):.2e}",
        f"dot kernelHIGH-vs-torchHIGH max|d|="
        f"{float(np.max(np.abs(k_hi - t_hi))):.2e}",
        f"exp rel-vs-f64: kernel={rel(k_exp, g_exp):.2e} "
        f"torch={rel(t_exp, g_exp):.2e} "
        f"bitdiff={int(np.sum(k_exp != t_exp))}/{k_exp.size}",
        f"log1p rel-vs-f64: kernel={rel(k_l1p, g_l1p):.2e} "
        f"torch={rel(t_l1p, g_l1p):.2e} "
        f"bitdiff={int(np.sum(k_l1p != t_l1p))}/{k_l1p.size}",
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel, default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}; DEFAULT = TF32 tensor cores, HIGHEST = fp32"
          + ("" if dev.type == "cuda" else " (plain versions; no TF32 on "
             "the CPU, so torch DEFAULT is fp32 there)"), flush=True)
    for line in run_probe(dev)[3]:
        print(line, flush=True)


if __name__ == "__main__":
    main()
