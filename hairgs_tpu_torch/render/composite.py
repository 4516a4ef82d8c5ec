"""Per-tile front-to-back compositing of the XLA path (counterpart of
hairgs_tpu/render/composite.py): `composite` with its own backward, the
image assembly, and the sequential oracle `composite_naive`.

`composite` takes the dense (num_tiles, K) layout of `bin_gaussians` and
walks it chunk by chunk. Inside a chunk the transmittance is formed in log
space, T_incl = T_start * exp(cumsum(log1p(-alpha))), and a pair is live
while T_incl >= T_EPS; the colour sum of the chunk is one batched product
(pixels x chunk) @ (chunk x channels). The backward walks the chunks in
reverse from the saved chunk-start transmittances and forms the suffix sum
in closed form. The JAX package lowers this through XLA, not Pallas, so its
counterpart here is stock torch operations and no hand-written kernel. Its
three contractions run at Precision.HIGHEST in JAX: here in full fp32,
which on the card needs TF32 off for matmuls (checked at each call).

Chunk semantics are those of the paged compositor (see composite_pairs.py):
a pixel that trips the latch in one chunk starts again at the next.
"""

import torch

ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
ALPHA_MAX = 0.99


def _tile_pixel_coords(grid_w: int, grid_h: int, tile_size: int, device):
    """(num_tiles, tile_size^2, 2) float pixel coordinates per tile."""
    t = torch.arange(grid_w * grid_h, dtype=torch.int32, device=device)
    p = torch.arange(tile_size * tile_size, dtype=torch.int32, device=device)
    px = ((t % grid_w) * tile_size)[:, None] + (p % tile_size)[None, :]
    py = ((t // grid_w) * tile_size)[:, None] + (p // tile_size)[None, :]
    return torch.stack([px, py], dim=-1).to(torch.float32)


def _chunk_alphas(xy_c, con_c, opa_c, pix, alpha_min):
    """alpha (NT, CH, P) with the cutoffs applied, and G, ok, dx, dy."""
    dx = xy_c[:, :, 0:1] - pix[:, None, :, 0]
    dy = xy_c[:, :, 1:2] - pix[:, None, :, 1]
    a = con_c[:, :, 0:1]
    b = con_c[:, :, 1:2]
    c = con_c[:, :, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    G = torch.exp(power)
    alpha = torch.clamp(opa_c[:, :, None] * G, max=ALPHA_MAX)
    ok = (power <= 0.0) & (alpha >= alpha_min)
    alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
    return alpha, G, ok, dx, dy


def _check_fp32_matmul(t):
    """The contractions are Precision.HIGHEST in JAX: on the card, refuse to
    run them with TF32 matmuls switched on."""
    if t.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32 is not False:
        raise RuntimeError("composite's contractions must run in full fp32: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")


def _chunk_weights(alpha, trans_in):
    """log1p(-alpha), the live mask and the weights alpha * T_excl."""
    l = torch.log1p(-alpha)
    cum = torch.cumsum(l, dim=1)
    live = trans_in[:, None, :] * torch.exp(cum) >= T_EPS
    t_excl = trans_in[:, None, :] * torch.exp(cum - l)
    w = torch.where(live, alpha * t_excl, torch.zeros_like(alpha))
    return l, live, t_excl, w


def _forward(xy_g, con_g, opa_g, feat_g, grid_w, grid_h, tile_size, chunk,
             alpha_min):
    nt, k = opa_g.shape
    if k % chunk:
        raise ValueError(f"pair capacity {k} must be divisible by chunk {chunk}")
    _check_fp32_matmul(feat_g)
    pix = _tile_pixel_coords(grid_w, grid_h, tile_size, opa_g.device)
    trans = torch.ones((nt, tile_size * tile_size), dtype=torch.float32,
                       device=opa_g.device)
    out = torch.zeros((nt, tile_size * tile_size, feat_g.shape[-1]),
                      dtype=torch.float32, device=opa_g.device)
    trans_starts = []
    for j in range(k // chunk):
        sl = slice(j * chunk, (j + 1) * chunk)
        alpha, *_ = _chunk_alphas(xy_g[:, sl], con_g[:, sl], opa_g[:, sl], pix,
                                  alpha_min)
        l, live, _, w = _chunk_weights(alpha, trans)
        out = out + torch.bmm(w.transpose(1, 2), feat_g[:, sl])
        trans_starts.append(trans)
        trans = trans * torch.exp(torch.sum(torch.where(live, l, torch.zeros_like(l)),
                                            dim=1))
    return out, trans, torch.stack(trans_starts)


def _backward(xy_g, con_g, opa_g, feat_g, trans_final, trans_starts, g_out,
              g_trans, grid_w, grid_h, tile_size, chunk, alpha_min):
    nt, k = opa_g.shape
    _check_fp32_matmul(feat_g)
    pix = _tile_pixel_coords(grid_w, grid_h, tile_size, opa_g.device)
    d_xy = torch.empty_like(xy_g)
    d_con = torch.empty_like(con_g)
    d_opa = torch.empty_like(opa_g)
    d_feat = torch.empty_like(feat_g)
    zero = torch.zeros((), dtype=torch.float32, device=opa_g.device)
    b_carry = trans_final * g_trans  # dL/dT_final enters the suffix term
    for j in reversed(range(k // chunk)):
        sl = slice(j * chunk, (j + 1) * chunk)
        con_c = con_g[:, sl]
        opa_c = opa_g[:, sl]
        feat_c = feat_g[:, sl]
        alpha, G, ok, dx, dy = _chunk_alphas(xy_g[:, sl], con_c, opa_c, pix,
                                             alpha_min)
        _, live, t_excl, w = _chunk_weights(alpha, trans_starts[j])
        fdotg = torch.bmm(feat_c, g_out.transpose(1, 2))  # (NT, CH, P)
        wf = w * fdotg
        csum = torch.cumsum(wf, dim=1)
        total = csum[:, -1, :]
        # exclusive suffix sum over the chunk, plus everything behind it
        B = (total[:, None, :] - csum) + b_carry[:, None, :]
        use = live & ok
        dalpha = torch.where(use, t_excl * fdotg - B / (1.0 - alpha), zero)
        d_opa[:, sl] = torch.sum(torch.where(use, G * dalpha, zero), dim=2)
        dpower = torch.where(use, opa_c[:, :, None] * G * dalpha, zero)
        a = con_c[:, :, 0:1]
        b = con_c[:, :, 1:2]
        c = con_c[:, :, 2:3]
        d_con[:, sl] = torch.stack([
            torch.sum(dpower * (-0.5 * dx * dx), dim=2),
            torch.sum(dpower * (-dx * dy), dim=2),
            torch.sum(dpower * (-0.5 * dy * dy), dim=2)], dim=-1)
        d_xy[:, sl] = torch.stack([
            torch.sum(dpower * (-(a * dx + b * dy)), dim=2),
            torch.sum(dpower * (-(c * dy + b * dx)), dim=2)], dim=-1)
        d_feat[:, sl] = torch.bmm(w, g_out)
        b_carry = b_carry + total
    return d_xy, d_con, d_opa, d_feat


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xy_g, con_g, opa_g, feat_g, grid_w, grid_h, tile_size,
                chunk, alpha_min):
        out, trans, trans_starts = _forward(xy_g, con_g, opa_g, feat_g, grid_w,
                                            grid_h, tile_size, chunk, alpha_min)
        # the JAX residuals: the inputs, final T and the chunk-start T only
        ctx.save_for_backward(xy_g, con_g, opa_g, feat_g, trans, trans_starts)
        ctx.cfg = (grid_w, grid_h, tile_size, chunk, alpha_min)
        ctx.set_materialize_grads(False)
        return out, trans

    @staticmethod
    def backward(ctx, g_out, g_trans):
        xy_g, con_g, opa_g, feat_g, trans, trans_starts = ctx.saved_tensors
        if g_out is None and g_trans is None:
            return (None,) * 9
        if g_out is None:
            g_out = torch.zeros(trans.shape + feat_g.shape[-1:],
                                dtype=torch.float32, device=trans.device)
        if g_trans is None:
            g_trans = torch.zeros_like(trans)
        grads = _backward(xy_g, con_g, opa_g, feat_g, trans, trans_starts,
                          g_out.contiguous(), g_trans, *ctx.cfg)
        return grads + (None,) * 5


def composite(xy_g, con_g, opa_g, feat_g, grid_w: int, grid_h: int,
              tile_size: int, chunk: int, alpha_min: float = ALPHA_MIN):
    """Front-to-back composite of per-tile depth-sorted Gaussian lists.

    xy_g (NT, K, 2) pixel-space means, con_g (NT, K, 3) conics, opa_g
    (NT, K) opacities (invalid slots must carry 0), feat_g (NT, K, C).
    Returns out (NT, P, C) without background and trans (NT, P)."""
    return _Composite.apply(xy_g, con_g, opa_g, feat_g, grid_w, grid_h,
                            tile_size, chunk, alpha_min)


def assemble_image(tiles, grid_w: int, grid_h: int, tile_size: int,
                   height: int, width: int):
    """(NT, P, ...) tile-major pixels -> (H, W, ...) image (cropped)."""
    trailing = tiles.shape[2:]
    img = tiles.reshape(grid_h, grid_w, tile_size, tile_size, *trailing)
    img = img.transpose(1, 2)
    img = img.reshape(grid_h * tile_size, grid_w * tile_size, *trailing)
    return img[:height, :width]


def composite_naive(xy, conic, opacity, features, depth, valid, width: int,
                    height: int, bg=None, rect=None, tile_size: int = 16,
                    alpha_min: float = ALPHA_MIN):
    """Sequential oracle with the CUDA loop's semantics, O(N * H * W): one
    global stable depth sort and a permanent per-pixel `done` latch. With
    `rect` (N, 4 tile-unit bounds) a Gaussian touches only the pixels of
    its rect's tiles, as binning makes the tiled compositors do. A test
    oracle only. Returns (image (H, W, C), final transmittance (H, W))."""
    dev = opacity.device
    n = opacity.shape[0]
    order = torch.argsort(depth.detach(), stable=True)
    xy = xy[order]
    conic = conic[order]
    opacity = torch.where(valid[order], opacity[order], torch.zeros_like(opacity))
    features = features[order]
    if rect is None:
        rect = torch.zeros((n, 4), dtype=torch.int32, device=dev)
        rect[:, 2:] = 2**30
    else:
        rect = rect[order]
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    pxf = xs.to(torch.float32)
    pyf = ys.to(torch.float32)
    ptx = torch.div(xs, tile_size, rounding_mode="floor")
    pty = torch.div(ys, tile_size, rounding_mode="floor")

    trans = torch.ones((height, width), dtype=torch.float32, device=dev)
    out = torch.zeros((height, width, features.shape[-1]), dtype=torch.float32,
                      device=dev)
    done = torch.zeros((height, width), dtype=torch.bool, device=dev)
    for i in range(n):
        dx = xy[i, 0] - pxf
        dy = xy[i, 1] - pyf
        power = (-0.5 * (conic[i, 0] * dx * dx + conic[i, 2] * dy * dy)
                 - conic[i, 1] * dx * dy)
        alpha = torch.clamp(opacity[i] * torch.exp(power), max=ALPHA_MAX)
        r = rect[i]
        in_rect = (ptx >= r[0]) & (ptx < r[2]) & (pty >= r[1]) & (pty < r[3])
        ok = (power <= 0.0) & (alpha >= alpha_min) & ~done & in_rect
        test_t = trans * (1.0 - alpha)
        saturate = ok & (test_t < T_EPS)
        done = done | saturate
        use = ok & ~saturate
        out = out + torch.where(use[..., None], (alpha * trans)[..., None] * features[i],
                                torch.zeros_like(out))
        trans = torch.where(use, test_t, trans)
    if bg is not None:
        out = out + trans[..., None] * bg
    return out, trans
