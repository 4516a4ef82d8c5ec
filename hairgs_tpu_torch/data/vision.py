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

The NeRSemble parser's other OpenCV operations, bit-equal to OpenCV 5's
(held to cv2 in the tests on random images and sizes):

- Files: `read_rgb`/`read_gray` and `write_png` through PIL, with
  `cv2.imread`'s None for a file that is missing or not an image. A colour
  PNG read as grey takes libpng's conversion, which OpenCV's reader asks
  for: (9797 R + 19234 G + 3737 B) >> 15, truncated (bit-equal over all
  2^24 colours, with or without an alpha channel).
- `dilate_uint8`: `cv2.dilate` with a k x k ones kernel is a k x k max
  pool whose -inf padding is dilate's default border.
- `resize_uint8`: `cv2.resize(INTER_LINEAR)` on uint8 grey. Equal sizes
  copy. Otherwise each output pixel blends two columns and then two rows
  with 11-bit fixed-point weights, each rounded from its float32
  coordinate (so the two weights need not sum to 2048). The row blend is
  OpenCV's vector form: each column term shifted right by 4, multiplied
  by the weight keeping the high 16 bits, summed, then (sum + 2) >> 2.
  A 2x downscale takes OpenCV's area path, which gives the same numbers.
"""

import numpy as np
import torch
import torch.nn.functional as F

PIXELS_PER_BLOCK = 1 << 18
RESIZE_COEF_BITS = 11


def rgb_to_gray_uint8(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 RGB -> (H, W) uint8, bit-equal to OpenCV 5's
    cvtColor(COLOR_RGB2GRAY)."""
    i = image.to(torch.int32)
    g = (i[..., 0] * 9798 + i[..., 1] * 19235 + i[..., 2] * 3735 + 16384) >> 15
    return g.to(torch.uint8)


def read_rgb(path: str):
    """(H, W, 3) uint8 RGB of an image file (what cv2.imread and a
    BGR->RGB conversion give), or None if it is missing or unreadable."""
    from PIL import Image, UnidentifiedImageError

    try:
        with Image.open(path) as im:
            return np.array(im.convert("RGB"))
    except (FileNotFoundError, UnidentifiedImageError):
        return None


def read_gray(path: str):
    """(H, W) uint8 of a PNG file as cv2.imread(IMREAD_GRAYSCALE) reads
    it, or None if it is missing or unreadable."""
    from PIL import Image, UnidentifiedImageError

    try:
        with Image.open(path) as im:
            if im.mode == "L":
                return np.array(im)
            rgb = np.asarray(im.convert("RGB"), dtype=np.int32)
    except (FileNotFoundError, UnidentifiedImageError):
        return None
    return ((rgb[..., 0] * 9797 + rgb[..., 1] * 19234 + rgb[..., 2] * 3737) >> 15).astype(
        np.uint8)


def write_png(path: str, image):
    """A uint8 (H, W) grey or (H, W, 3) RGB array or tensor as a PNG."""
    from PIL import Image

    if isinstance(image, torch.Tensor):
        image = image.cpu().numpy()
    Image.fromarray(np.ascontiguousarray(image)).save(path)


def dilate_uint8(image: torch.Tensor, ksize: int) -> torch.Tensor:
    """cv2.dilate(image, np.ones((ksize, ksize))) of an (H, W) uint8 image,
    on its device (odd ksize, anchor at the centre)."""
    x = image.to(torch.float32)[None, None]
    y = F.max_pool2d(x, ksize, stride=1, padding=ksize // 2)
    return y[0, 0].to(torch.uint8)


def _resize_taps(n_src: int, n_dst: int, clamp: bool):
    """OpenCV's INTER_LINEAR first source index and its two fixed-point
    weights per output index, for one axis (float32 coordinates, as
    OpenCV). With `clamp` (columns), an index below 0 or at the last
    source index is clamped with a zero fraction, taking the whole weight."""
    f = ((np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        f[(s < 0) | (s >= n_src - 1)] = 0
        s = np.clip(s, 0, n_src - 1)
    one = np.float32(1 << RESIZE_COEF_BITS)
    return (s, np.rint((np.float32(1) - f) * one).astype(np.int32),
            np.rint(f * one).astype(np.int32))


def resize_uint8(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """cv2.resize(image, (width, height)) (INTER_LINEAR) of an (H, W) uint8
    image, bit for bit, on its device."""
    if image.dim() != 2:
        raise ValueError(f"resize_uint8 takes an (H, W) image, got {tuple(image.shape)}")
    h, w = image.shape
    if (h, w) == (height, width):
        return image.clone()

    def taps(n_src, n_dst, clamp):
        i, w0, w1 = _resize_taps(n_src, n_dst, clamp)
        return [torch.tensor(a, device=image.device) for a in (
            np.clip(i, 0, n_src - 1), np.clip(i + 1, 0, n_src - 1), w0, w1)]

    x0, x1, a0, a1 = taps(w, width, True)
    y0, y1, b0, b1 = taps(h, height, False)
    src = image.to(torch.int32)
    rows = src[:, x0] * a0 + src[:, x1] * a1
    t0 = ((rows[y0] >> 4) * b0[:, None]) >> 16
    t1 = ((rows[y1] >> 4) * b1[:, None]) >> 16
    return torch.clamp((t0 + t1 + 2) >> 2, 0, 255).to(torch.uint8)


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
