"""2D orientation-field estimation from images with a Gabor filter bank
(counterpart of hairgs_tpu/data/vision.py, which calls OpenCV).

Parity target: utils/vision.py:5-62 — per-pixel argmax over oriented Gabor
responses (180 angles, 31x31 kernels, sigma=2, lambda=3, gamma=0.5) plus an
inverse-variance confidence normalised to [0, 1].

The port needs no OpenCV: it computes OpenCV's arithmetic in torch, on the
device of its input.

- Grey: `cv2.cvtColor(RGB2GRAY)` on uint8 is fixed point,
  (9798 R + 19235 G + 3735 B + 2^14) >> 15 in OpenCV 5 (bit-equal over all
  2^24 colours; OpenCV 4 rounded with 14 bits: 4899, 9617, 1868).
- Kernels: `cv2.getGaborKernel` in float64, stored as float32, with its
  flipped indexing; for psi = 0 a kernel is point-symmetric, so correlation
  and convolution agree.
- Filter: `cv2.filter2D(gray_uint8, -1, k)` correlates with a
  BORDER_REFLECT_101 border (`F.pad(mode="reflect")`) and saturates to
  uint8, rounding half to even (negative responses become 0). OpenCV
  correlates a 31x31 kernel through a float32 DFT; the port sums directly
  in float32 (`F.conv2d`), so an entry within rounding of a .5 boundary may
  round the other way (1 in ~30 000 entries on random images).
- The argmax takes the first of equal responses, as `np.argmax` does.
- Variance and confidence in float64, as the reference's
  `np.ones(...) * orientations` makes them, in blocks of pixels.

cuDNN runs float32 convolutions in TF32 unless told otherwise, and TF32's
~1e-3 relative error would flip the rounding of many responses: the filter
refuses to run on the card with `torch.backends.cudnn.allow_tf32` on (the
package switches it off when it is imported).
"""

import numpy as np
import torch
import torch.nn.functional as F

PIXELS_PER_BLOCK = 1 << 18


def rgb_to_gray_uint8(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 RGB -> (H, W) uint8, bit-equal to OpenCV 5's
    cvtColor(COLOR_RGB2GRAY)."""
    i = image.to(torch.int32)
    g = (i[..., 0] * 9798 + i[..., 1] * 19235 + i[..., 2] * 3735 + 16384) >> 15
    return g.to(torch.uint8)


def gabor_kernel(ksize: int, sigma: float, theta: float, lambd: float,
                 gamma: float, psi: float = 0.0) -> np.ndarray:
    """cv2.getGaborKernel((ksize, ksize), sigma, theta, lambd, gamma, psi,
    CV_32F): float64 arithmetic, float32 result."""
    sigma_x = sigma
    sigma_y = sigma / gamma
    c, s = np.cos(theta), np.sin(theta)
    half = ksize // 2
    ex = -0.5 / (sigma_x * sigma_x)
    ey = -0.5 / (sigma_y * sigma_y)
    cscale = np.pi * 2 / lambd
    y, x = np.meshgrid(np.arange(-half, half + 1, dtype=np.float64),
                       np.arange(-half, half + 1, dtype=np.float64), indexing="ij")
    xr = x * c + y * s
    yr = -x * s + y * c
    v = np.exp(ex * xr * xr + ey * yr * yr) * np.cos(cscale * xr + psi)
    # OpenCV stores v(x, y) at (ymax - y, xmax - x)
    return v[::-1, ::-1].astype(np.float32)


def gabor_responses(gray: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """(H, W) uint8 grey, (A, k, k) float32 kernels -> (A, H, W) float32
    responses rounded and saturated to [0, 255] as cv2.filter2D's uint8
    output."""
    if gray.device.type == "cuda" and torch.backends.cudnn.allow_tf32 is not False:
        raise RuntimeError("the Gabor filter must run in full fp32: "
                           "torch.backends.cudnn.allow_tf32 is on")
    half = kernels.shape[-1] // 2
    x = F.pad(gray.to(torch.float32)[None, None], (half,) * 4, mode="reflect")
    r = F.conv2d(x, kernels[:, None])[0]
    return torch.clamp(torch.round(r), 0.0, 255.0)


def estimate_orientation_field(image: torch.Tensor, kernel_size=31, sigma=2,
                               lambda_=3, gamma=0.5, num_angles=180):
    """Orientation (H, W) float64 radians in [0, pi] and confidence (H, W)
    float32 in [0, 1] of a uint8 image ((H, W, 3) RGB or (H, W) grey), on
    the image's device."""
    dev = image.device
    gray = rgb_to_gray_uint8(image) if image.dim() > 2 else image
    orientations = np.linspace(0, np.pi, num_angles)
    kernels = torch.tensor(np.stack([
        gabor_kernel(kernel_size, sigma, t, lambda_, gamma) for t in orientations]),
        device=dev)
    with torch.no_grad():
        responses = gabor_responses(gray, kernels)
        idx = torch.argmax(responses, dim=0)  # the first of equal maxima
        orient = torch.tensor(orientations, device=dev)
        # angdiff(o_i, o_j)^2 in float64, as the reference forms it per pixel
        a = orient[:, None] - orient[None, :]
        diff = np.pi / 2 - torch.abs(torch.abs(a) - np.pi / 2)
        sq = diff * diff
        resp = responses.reshape(num_angles, -1)
        flat_idx = idx.reshape(-1)
        variance = torch.empty(flat_idx.shape[0], dtype=torch.float64, device=dev)
        for p0 in range(0, flat_idx.shape[0], PIXELS_PER_BLOCK):
            r = resp[:, p0:p0 + PIXELS_PER_BLOCK].T.to(torch.float64)
            num = torch.sum(sq[flat_idx[p0:p0 + PIXELS_PER_BLOCK]] * r, dim=1)
            variance[p0:p0 + PIXELS_PER_BLOCK] = num / (torch.sum(r, dim=1) + 1e-7)
        variance = variance.reshape(idx.shape)
        has_var = variance != 0
        confidence = torch.ones(idx.shape, dtype=torch.float32, device=dev)
        if bool(has_var.any()):
            valid = 1.0 / (variance * variance)[has_var]
            confidence[has_var] = (valid / torch.max(valid)).to(torch.float32)
        return orient[idx], confidence
