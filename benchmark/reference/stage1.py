"""Plain PyTorch reference of the first Stage-I training steps: the
initial Gaussians from the point cloud, the fused 7-channel splatting render
(EWA projection, the tile budget, the per-tile cap and the pair capacity,
depth-ordered front-to-back compositing in chunks), the L1 + D-SSIM, mask
and orientation losses, the viewspace statistics, and Adam.

It follows the semantics of the 3DGS rasteriser as the program states them
(per-pair alpha gate, alpha clamp 0.99, transmittance cut 1e-4 per chunk of
the tile's list, quantised-depth order, the first `max_tiles_per_gaussian`
tiles whose box can pass the gate), written from scratch in dense tensor
operations with autograd: no kernel, no paging. It imports torch, numpy and
math only, and takes nothing that the program made: it works out the
initial parameters, the cameras and the raster tables again from the
capture.

`precision="tf32"` rounds the operands of every matrix product and of the
SSIM convolution to TF32 (10 mantissa bits, round to nearest even), as a
tensor core does: the control that has to fail the comparison.
"""

import math
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

SH_C0 = 0.28209479177387814
T_EPS = 1e-4
ALPHA_MAX = 0.99
TILE = 16
PIX = TILE * TILE
CAP_EDGE = 64  # ranks either side of a tile cap's cut counted as near it
LEAVES = ("xyz", "features_dc", "scaling", "rotation", "opacity", "mask")


def tf32(x):
    """x rounded to TF32 (round to nearest even on the 13 low mantissa
    bits), kept in a float32 tensor."""
    i = x.detach().contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return torch.where(torch.isfinite(x), r.view(torch.float32), x.detach())


class _MatmulTF32(torch.autograd.Function):
    """a @ b with every operand of the forward and backward products
    rounded to TF32 and float32 accumulation, as a tensor core computes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        ga = g @ tf32(b).transpose(-1, -2)
        gb = tf32(a).transpose(-1, -2) @ g
        # undo broadcasting over batch dimensions
        while ga.dim() > a.dim():
            ga = ga.sum(0)
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        return ga.sum_to_size(a.shape), gb.sum_to_size(b.shape)


class _ConvTF32(torch.autograd.Function):
    """conv2d of the SSIM window, operands rounded to TF32 forward and
    backward."""

    @staticmethod
    def forward(ctx, x, w, padding, groups):
        ctx.save_for_backward(x, w)
        ctx.cfg = (padding, groups)
        return F.conv2d(tf32(x), tf32(w), padding=padding, groups=groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        padding, groups = ctx.cfg
        gx = torch.nn.grad.conv2d_input(x.shape, tf32(w), tf32(g), padding=padding,
                                        groups=groups)
        return gx, None, None, None


class Precision:
    def __init__(self, name: str):
        if name not in ("fp32", "tf32"):
            raise ValueError(name)
        self.low = name == "tf32"

    def mm(self, a, b):
        return _MatmulTF32.apply(a, b) if self.low else a @ b

    def conv(self, x, w, padding, groups):
        if self.low:
            return _ConvTF32.apply(x, w, padding, groups)
        return F.conv2d(x, w, padding=padding, groups=groups)


# --- cameras ---------------------------------------------------------------

def qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y]])


class View(NamedTuple):
    world_view: torch.Tensor  # (4,4)
    full_proj: torch.Tensor  # (4,4)
    center: torch.Tensor  # (3,)
    tanfovx: torch.Tensor
    tanfovy: torch.Tensor
    width: int
    height: int
    image: torch.Tensor  # (H,W,3)
    mask: torch.Tensor  # (H,W) {0,1}
    orientation: torch.Tensor  # (H,W) radians
    confidence: torch.Tensor  # (H,W)


def make_view(cam: dict, maps, device) -> View:
    """The camera as the COLMAP files state it (SIMPLE_PINHOLE, world to
    camera qvec/tvec; znear 0.01, zfar 100) and its targets decoded from the
    uint8 images as a loader reads them."""
    rgb, mask, orient, conf = maps
    w, h, f = cam["width"], cam["height"], cam["focal"]
    rt = np.zeros((4, 4))
    rt[:3, :3] = qvec2rotmat(cam["qvec"])
    rt[:3, 3] = cam["tvec"]
    rt[3, 3] = 1.0
    w2v = np.linalg.inv(np.linalg.inv(rt)).astype(np.float32)
    fovx = 2 * math.atan(w / (2 * f))
    fovy = 2 * math.atan(h / (2 * f))
    znear, zfar = 0.01, 100.0
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = znear / (math.tan(fovx / 2) * znear)
    proj[1, 1] = znear / (math.tan(fovy / 2) * znear)
    proj[3, 2] = 1.0
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    full = proj @ w2v
    center = np.linalg.inv(w2v)[:3, 3]

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return View(world_view=t(w2v), full_proj=t(full), center=t(center),
                tanfovx=t(math.tan(fovx * 0.5)), tanfovy=t(math.tan(fovy * 0.5)),
                width=w, height=h,
                image=t(rgb.astype(np.float32) / 255.0),
                mask=t(mask.astype(np.float32) * (1.0 / 255.0) > 0.5),
                orientation=t(orient.astype(np.float32) * (math.pi / 255.0)),
                confidence=t(conf.astype(np.float32) * (1.0 / 255.0)))


def camera_extent(cams) -> float:
    """1.1 x the largest distance of a camera centre from their mean."""
    centers = []
    for cam in cams:
        rt = np.eye(4)
        rt[:3, :3] = qvec2rotmat(cam["qvec"])
        rt[:3, 3] = cam["tvec"]
        centers.append(np.linalg.inv(rt)[:3, 3])
    c = np.stack(centers)
    return float(np.linalg.norm(c - c.mean(axis=0), axis=1).max() * 1.1)


# --- the model ---------------------------------------------------------------

def initial_leaves(points, colours_u8, device, chunk: int = 2048) -> Dict[str, torch.Tensor]:
    """3DGS initialisation: scale log(sqrt(mean squared distance to the
    three nearest other points)) on all axes (at least 1e-7 squared), the
    identity rotation, opacity 0.1, mask 0.5, the colour as the SH DC term.
    Distances are exact differences, not a Gram-matrix expansion."""
    pts = torch.tensor(points, dtype=torch.float32, device=device)
    d2 = []
    for s in range(0, pts.shape[0], chunk):
        d = torch.cdist(pts[s:s + chunk], pts,
                        compute_mode="donot_use_mm_for_euclid_dist")
        d2.append(torch.topk(d * d, 4, dim=1, largest=False).values[:, 1:].mean(dim=1))
    d2 = torch.clamp(torch.cat(d2), min=1e-7)
    n = pts.shape[0]
    rgb = torch.tensor(colours_u8, dtype=torch.float32, device=device) / 255.0
    rot = torch.zeros((n, 4), device=device)
    rot[:, 0] = 1.0
    return dict(
        xyz=pts,
        features_dc=((rgb - 0.5) / SH_C0)[:, None, :],
        scaling=torch.log(torch.sqrt(d2))[:, None].repeat(1, 3),
        rotation=rot,
        opacity=torch.full((n, 1), math.log(0.1 / 0.9), device=device),
        mask=torch.zeros((n, 1), device=device))


def rotation_matrices(q):
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-24)
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)],
        dim=-1).reshape(q.shape[:-1] + (3, 3))


def features(p):
    """(N, 7): rgb from the SH DC term (degree 0, clamped at 0), the
    sigmoid mask, the world direction of the longest axis."""
    rgb = torch.clamp(SH_C0 * p["features_dc"][:, 0, :] + 0.5, min=0.0)
    axis = torch.argmax(torch.exp(p["scaling"]), dim=1)
    orient = torch.gather(rotation_matrices(p["rotation"]), 2,
                          axis[:, None, None].expand(-1, 3, 1))[..., 0]
    return torch.cat([rgb, torch.sigmoid(p["mask"]), orient], dim=1)


# --- projection --------------------------------------------------------------

def geometry(p, prec: Precision):
    """(centres (N,3), world covariances (N,3,3), opacities (N,)) of the
    Gaussians: R diag(s^2) R^T from the normalised quaternion and the
    exponentiated log-scales."""
    scale = torch.exp(p["scaling"])
    q = p["rotation"]
    qn = torch.maximum(torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-24),
                       q.new_tensor(1e-12))
    R = rotation_matrices(q / qn)
    M = R * scale[:, None, :]
    return p["xyz"], prec.mm(M, M.transpose(1, 2)), torch.sigmoid(p["opacity"])[:, 0]


def project(p, view: View, prec: Precision, alpha_min: float, offset=None,
            geometry_fn=None):
    """EWA splat of every Gaussian: dict of xy (pixels), conic, opacity,
    depth, lambda1, radius, the binning rect and validity. `geometry_fn`
    (default `geometry`) gives the centres, covariances and opacities."""
    w, h = view.width, view.height
    gw, gh = (w + TILE - 1) // TILE, (h + TILE - 1) // TILE
    xyz, cov3, opa = (geometry_fn or geometry)(p, prec)

    hom = prec.mm(torch.cat([xyz, torch.ones_like(xyz[:, :1])], dim=1), view.full_proj.T)
    pw = 1.0 / (hom[:, 3] + 1e-7)
    ndc = hom[:, :2] * pw[:, None]
    wv = view.world_view
    W = wv[:3, :3]
    depth = xyz @ wv[2, :3] + wv[2, 3]
    t = prec.mm(xyz, W.T) + wv[:3, 3]
    tz = torch.where(t[:, 2] > 0.19, t[:, 2], torch.ones_like(t[:, 2]))
    fx = w / (2.0 * view.tanfovx)
    fy = h / (2.0 * view.tanfovy)
    limx, limy = 1.3 * view.tanfovx, 1.3 * view.tanfovy
    tx = torch.minimum(torch.maximum(t[:, 0] / tz, -limx), limx) * tz
    ty = torch.minimum(torch.maximum(t[:, 1] / tz, -limy), limy) * tz
    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    zero = torch.zeros_like(tz)
    J = torch.stack([torch.stack([fx * inv_tz, zero, -fx * tx * inv_tz2], -1),
                     torch.stack([zero, fy * inv_tz, -fy * ty * inv_tz2], -1)], -2)
    T = prec.mm(J, W)
    cov2 = prec.mm(prec.mm(T, cov3), T.transpose(1, 2))
    cxx, cxy, cyy = cov2[:, 0, 0] + 0.3, cov2[:, 0, 1], cov2[:, 1, 1] + 0.3
    det = cxx * cyy - cxy * cxy
    det_ok = det != 0.0
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([cyy * inv, -cxy * inv, cxx * inv], dim=1)
    mid = 0.5 * (cxx + cyy)
    lam1 = (mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))).detach()
    radius = torch.ceil(3.0 * torch.sqrt(lam1))
    xy = torch.stack([((ndc[:, 0] + 1.0) * w - 1.0) * 0.5,
                      ((ndc[:, 1] + 1.0) * h - 1.0) * 0.5], dim=1)
    xyd = xy.detach()

    def rect(r):
        def cl(v, hi):
            return torch.clamp(torch.floor(v / TILE), 0, hi).nan_to_num(0).to(torch.int64)
        return torch.stack([cl(xyd[:, 0] - r, gw), cl(xyd[:, 1] - r, gh),
                            cl(xyd[:, 0] + r + TILE - 1, gw),
                            cl(xyd[:, 1] + r + TILE - 1, gh)], dim=1)

    r3 = rect(radius)
    touched = (r3[:, 2] - r3[:, 0]) * (r3[:, 3] - r3[:, 1])
    r_alpha = torch.sqrt(2.0 * lam1 * torch.log(torch.clamp(opa.detach() / alpha_min, min=1.0)))
    cull = rect(torch.minimum(radius, torch.ceil(r_alpha) + 1.0))
    valid = (depth.detach() > 0.2) & det_ok & (touched > 0)
    if offset is not None:
        xy = xy + offset * torch.tensor([0.5 * w, 0.5 * h], device=xy.device)
    return dict(xy=xy, conic=conic, opacity=opa, depth=depth.detach(),
                radius=torch.where(valid, radius, torch.zeros_like(radius)),
                rect=cull, valid=valid, grid=(gw, gh))


# --- binning -----------------------------------------------------------------

def tile_min_power(xy, conic, tx, ty):
    """Least 0.5 a dx^2 + b dx dy + 0.5 c dy^2 over each tile's pixel box
    (+-0.5 px): 0 when the centre lies inside, else the least of the four
    edges, each minimised along the edge and clamped to it."""
    a, b, c = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
    a_s, c_s = torch.clamp(a, min=1e-12), torch.clamp(c, min=1e-12)
    lx = (tx * TILE).to(torch.float32) - 0.5 - xy[:, 0:1]
    hx = lx + TILE
    ly = (ty * TILE).to(torch.float32) - 0.5 - xy[:, 1:2]
    hy = ly + TILE

    def q(dx, dy):
        return 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy

    def ex(dx):
        return q(dx, torch.minimum(torch.maximum(-b * dx / c_s, ly), hy))

    def ey(dy):
        return q(torch.minimum(torch.maximum(-b * dy / a_s, lx), hx), dy)

    inside = (lx <= 0) & (hx >= 0) & (ly <= 0) & (hy >= 0)
    edges = torch.minimum(torch.minimum(ex(lx), ex(hx)), torch.minimum(ey(ly), ey(hy)))
    return torch.where(inside, torch.zeros_like(edges), edges)


class Tables(NamedTuple):
    truncated: torch.Tensor  # (N,) bool: more passing cells than the budget
    capped: torch.Tensor  # (N,) bool: a pair near the cut of a tile the cap cut
    tile: torch.Tensor  # (P,) tile of each kept pair, in compositing order
    gid: torch.Tensor  # (P,) its Gaussian
    counts: torch.Tensor  # (num_tiles,) pairs each tile composites
    overflow_pairs: int
    overflow_tiles: int
    overflow_capacity: int
    pairs_demand: int


def bin_pairs(pr, rc: dict, arena_rows: int, probe_mult: int = 4) -> Tables:
    """The (tile, Gaussian) pairs each tile composites, nearest first:
    each Gaussian keeps the first `max_tiles` cells of its rect (row
    major, among the first probe_mult x max_tiles) whose box can pass the
    alpha gate; a tile keeps its nearest `max_pairs` by quantised depth
    (ties by Gaussian index); with a pair capacity, tiles whose
    chunk-padded list starts past the table's content are cut."""
    gw, gh = pr["grid"]
    nt = gw * gh
    dev = pr["xy"].device
    rect, valid = pr["rect"], pr["valid"]
    r_max = rc["max_tiles"]
    rw = rect[:, 2] - rect[:, 0]
    count = rw * (rect[:, 3] - rect[:, 1])
    r_probe = r_max * probe_mult
    r = torch.arange(r_probe, device=dev)
    rw1 = torch.clamp(rw, min=1)[:, None]
    tx = rect[:, 0:1] + r[None] % rw1
    ty = rect[:, 1:2] + torch.div(r[None], rw1, rounding_mode="floor")
    opa = torch.where(valid, pr["opacity"].detach(), torch.zeros_like(pr["opacity"]))
    q_cut = torch.log(torch.clamp(opa, min=1e-12) / rc["alpha_min"])
    ok = valid[:, None] & (r[None] < count[:, None])
    ok = ok & (tile_min_power(pr["xy"].detach(), pr["conic"].detach(), tx, ty)
               <= q_cut[:, None] + 1e-4)
    rank = torch.cumsum(ok.to(torch.int64), dim=1)
    keep = ok & (rank <= r_max)
    n_pass = ok.sum(dim=1)
    tested = torch.clamp(torch.clamp(count, max=r_probe), min=1)
    untested = torch.round(torch.clamp(count - r_probe, min=0).to(torch.float32)
                           * (n_pass.to(torch.float32) / tested.to(torch.float32)))
    lost = torch.clamp(n_pass - r_max, min=0) + untested.to(torch.int64)
    overflow_pairs = int(torch.where(valid, lost, torch.zeros_like(lost)).sum())

    g_idx, slot = torch.nonzero(keep, as_tuple=True)
    tile = (ty * gw + tx)[g_idx, slot]
    depth_bits = max(1, min(23, int(np.floor(np.log2(2**31 / (nt + 1))))))
    levels = (1 << depth_bits) - 1
    d = pr["depth"]
    dq = (torch.clamp(d / (d + 1.0), 0.0, 1.0) * levels).to(torch.int64)
    n = d.shape[0]
    key = (tile * (levels + 1) + dq[g_idx]) * n + g_idx
    order = torch.argsort(key)
    tile, g_idx = tile[order], g_idx[order]
    counts = torch.bincount(tile, minlength=nt)
    first = torch.cumsum(counts, 0) - counts
    rank_in_tile = torch.arange(tile.shape[0], device=dev) - first[tile]
    overflow_tiles = int(torch.clamp(counts - rc["max_pairs"], min=0).sum())
    edge = (counts[tile] > rc["max_pairs"]) & ((rank_in_tile - rc["max_pairs"]).abs() < CAP_EDGE)
    capped = torch.zeros(n, dtype=torch.bool, device=dev)
    capped[g_idx[edge]] = True
    counts = torch.clamp(counts, max=rc["max_pairs"])

    chunk = rc["chunk"]
    padded = (counts + chunk - 1) // chunk * chunk
    starts = torch.cumsum(padded, 0) - padded
    demand = int(starts[-1] + padded[-1] + chunk)
    overflow_capacity = 0
    if rc["pair_capacity"] > 0:
        worst = arena_rows * r_max + (nt + 1) * chunk
        p_pad = max((min(rc["pair_capacity"], worst) + chunk - 1) // chunk * chunk,
                    2 * chunk)
        allowed = torch.clamp(p_pad - chunk - starts, min=0)
        cut = torch.minimum(counts, allowed)
        overflow_capacity = int((counts - cut).sum())
        counts = cut
    kept = rank_in_tile < counts[tile]
    return Tables(truncated=n_pass > r_max, capped=capped, tile=tile[kept], gid=g_idx[kept],
                  counts=counts,
                  overflow_pairs=overflow_pairs, overflow_tiles=overflow_tiles,
                  overflow_capacity=overflow_capacity, pairs_demand=demand)


# --- compositing -------------------------------------------------------------

def composite(pr, feats, tables: Tables, chunk: int, alpha_min: float, width: int,
              height: int):
    """(H, W, C): each tile's pairs front to back. Inside a chunk of the
    tile's list a pixel takes pairs while its transmittance stays >= T_EPS
    and stops for the rest of the chunk at the first that would take it
    below; the next chunk starts again from the transmittance it kept."""
    gw, gh = pr["grid"]
    dev = feats.device
    c = feats.shape[1]
    counts = tables.counts
    nch = (counts + chunk - 1) // chunk
    first = torch.cumsum(counts, 0) - counts
    pix = torch.arange(PIX, device=dev)
    xy = torch.cat([pr["xy"], torch.zeros_like(pr["xy"][:1])])
    conic = torch.cat([pr["conic"], torch.zeros_like(pr["conic"][:1])])
    opa = torch.cat([torch.where(pr["valid"], pr["opacity"], torch.zeros_like(pr["opacity"])),
                     pr["opacity"].new_zeros(1)])
    feat = torch.cat([torch.where(pr["valid"][:, None], feats, torch.zeros_like(feats)),
                      feats.new_zeros((1, c))])
    pad = pr["xy"].shape[0]
    out_tiles, out_ids = [], []
    for n in torch.unique(nch[nch > 0]).tolist():
        tiles = torch.nonzero(nch == n)[:, 0]
        k = torch.arange(n * chunk, device=dev)
        has = k[None] < counts[tiles, None]
        pos = torch.where(has, first[tiles, None] + k[None], torch.zeros_like(k[None]))
        gid = torch.where(has, tables.gid[pos], torch.full_like(pos, pad))
        px = ((tiles % gw) * TILE)[:, None].to(torch.float32) + (pix % TILE).to(torch.float32)
        py = ((tiles // gw) * TILE)[:, None].to(torch.float32) + (pix // TILE).to(torch.float32)
        T = torch.ones((tiles.shape[0], PIX), device=dev)
        acc = torch.zeros((tiles.shape[0], PIX, c), device=dev)
        for j in range(n):
            g = gid[:, j * chunk:(j + 1) * chunk]
            dx = xy[g, 0][..., None] - px[:, None, :]
            dy = xy[g, 1][..., None] - py[:, None, :]
            a, b, cc = (conic[g, i][..., None] for i in range(3))
            power = -0.5 * (a * dx * dx + cc * dy * dy) - b * dx * dy
            alpha = torch.clamp(opa[g][..., None] * torch.exp(power), max=ALPHA_MAX)
            ok = (power <= 0.0) & (alpha >= alpha_min)
            alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
            om = 1.0 - alpha
            prod = torch.cumprod(om, dim=1)
            alive = (T[:, None, :] * prod).detach() >= T_EPS
            before = T[:, None, :] * torch.cat([torch.ones_like(prod[:, :1]), prod[:, :-1]], 1)
            wgt = torch.where(alive, alpha * before, torch.zeros_like(alpha))
            acc = acc + torch.einsum("tkp,tkc->tpc", wgt, feat[g])
            T = T * torch.prod(torch.where(alive, om, torch.ones_like(om)), dim=1)
        out_tiles.append(acc)
        out_ids.append(tiles)
    img = torch.zeros((gw * gh, PIX, c), device=dev)
    if out_tiles:
        img = img.index_put((torch.cat(out_ids),), torch.cat(out_tiles))
    img = img.reshape(gh, gw, TILE, TILE, c).permute(0, 2, 1, 3, 4)
    return img.reshape(gh * TILE, gw * TILE, c)[:height, :width]


# --- losses ------------------------------------------------------------------

def ssim(x, y, prec: Precision):
    """Mean SSIM, 11 x 11 Gaussian window (sigma 1.5), zero padding, per
    channel; x, y (H, W, 3)."""
    g = torch.exp(-((torch.arange(11, dtype=torch.float64) - 5) ** 2) / (2 * 1.5 ** 2))
    g = (g / g.sum()).to(torch.float32)
    win = (g[:, None] @ g[None, :]).to(x.device).expand(3, 1, 11, 11).contiguous()

    def f(t):
        return prec.conv(t.permute(2, 0, 1)[None], win, padding=5, groups=3)[0]

    mu1, mu2 = f(x), f(y)
    s11 = f(x * x) - mu1 * mu1
    s22 = f(y * y) - mu2 * mu2
    s12 = f(x * y) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return torch.mean(((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
                      / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2)))


def losses(ch, view: View, opt: dict, prec: Precision, rows=None):
    """(total, photometric): (1 - l) L1 + l (1 - SSIM) on rgb, plus
    lambda_mask x BCE-with-logits of the (already sigmoided) mask channel,
    plus lambda_orientation x the confidence-weighted bidirectional angle
    error over the hair pixels. `rows` keeps only the first rows (a fault
    for the tests: half of the pixels left out, the mean over the rest)."""
    img, gt, m = ch[..., :3], view.image, view.mask
    orient, target, conf = ch[..., 4:7], view.orientation, view.confidence
    if rows is not None:
        img, gt, m = img[:rows], gt[:rows], m[:rows]
        orient, target, conf, ch = orient[:rows], target[:rows], conf[:rows], ch[:rows]
    lam = opt["lambda_dssim"]
    photo = (1 - lam) * torch.mean(torch.abs(img - gt)) + lam * (1 - ssim(img, gt, prec))
    x = ch[..., 3]
    bce = torch.mean(torch.clamp(x, min=0) - x * m + torch.log1p(torch.exp(-torch.abs(x))))
    ov = prec.mm(orient, view.world_view[:3, :3].T)
    v = ov[..., :2]
    v = v / (torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-24) + 1e-7)
    yy = torch.where(v[..., 1] < 1e-7, v[..., 1] + 1e-7, v[..., 1])
    theta = torch.atan2(v[..., 0], yy)
    theta = torch.where(theta < 0, theta + math.pi, theta)
    diff = math.pi / 2 - torch.abs(torch.abs(theta - target) - math.pi / 2)
    orient_loss = torch.sum(diff * conf * m) / torch.clamp(torch.sum(m), min=1.0)
    total = photo + opt["lambda_mask"] * bce + opt["lambda_orientation"] * orient_loss
    return total, photo


# --- the steps ---------------------------------------------------------------

def expon_lr(step, init, final, max_steps):
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(init) * (1 - t) + math.log(final) * t)


class Controllers:
    """The raster tables between steps: the tile budget doubles (to 64)
    when a step loses more than 1% of n x budget pairs, the pair capacity
    grows to 1.25 x the demand (granule steps) when a step overflows it,
    the per-tile cap doubles (to 8192) when it drops more than 0.1% of the
    demand. (Shrinking needs 20-50 clean steps and cannot happen in the
    steps followed here.)"""

    def __init__(self, rc: dict, granule: int):
        self.rc = dict(rc)
        self.granule = granule

    def update(self, tab: Tables, n: int):
        rc = self.rc
        if tab.overflow_pairs > 0.01 * n * rc["max_tiles"] and rc["max_tiles"] < 64:
            rc["max_tiles"] = min(rc["max_tiles"] * 2, 64)
        if rc["adaptive_capacity"] and tab.overflow_capacity > 0:
            want = int(tab.pairs_demand * 1.25)
            bucket = (want + self.granule - 1) // self.granule * self.granule
            rc["pair_capacity"] = max(bucket, rc["pair_capacity"] + self.granule)
        if (tab.overflow_tiles > 0.001 * max(tab.pairs_demand, 1)
                and rc["max_pairs"] < 8192):
            rc["max_pairs"] = min(rc["max_pairs"] * 2, 8192)


class Readout(NamedTuple):
    """What the comparison reads of a run of the first steps."""
    losses: List[float]  # total loss of each step
    grads: Dict[str, torch.Tensor]  # the first step's gradient per leaf
    changes: Dict[str, torch.Tensor]  # parameters after the steps minus before
    grad_accum: torch.Tensor  # the first step's viewspace-gradient norm per Gaussian


class Followed(NamedTuple):
    readout: Readout
    order: List[int]  # the view of each step
    agree: List[float]  # the share of Gaussians whose held radius matched
    truncated: torch.Tensor  # (N,) bool: the tile budget cut it in the first step
    capped: torch.Tensor  # (N,) bool: near a tile cap's cut in the first step


class Model(NamedTuple):
    """How a reference model's leaves become splats and are optimised."""
    leaves: tuple  # the optimised leaves, in the order their gradients are read
    position: str  # the leaf whose learning rate follows the exponential schedule
    geometry: Callable  # (p, prec) -> (centres, covariances, opacities)
    features: Callable  # p -> (N, 7) feature channels
    lrs: Callable  # opt -> {leaf: learning rate} (the position's is set per step)
    regulariser: Optional[Callable] = None  # (p, prec) -> term added to the loss


GAUSSIANS = Model(
    LEAVES, "xyz", geometry, features,
    lambda opt: dict(xyz=0.0, features_dc=opt["feature_lr"], scaling=opt["scaling_lr"],
                     rotation=opt["rotation_lr"], opacity=opt["opacity_lr"],
                     mask=opt["mask_lr"]))


def pick_view(p, views: List[View], prev, held, alpha_min: float, model: Model = GAUSSIANS):
    """The view whose screen radii (0 where a Gaussian does not project),
    folded into the running maximum `prev`, best give the maximum radii
    `held` after the step; with the share that matches."""
    with torch.no_grad():
        best = None
        for i, v in enumerate(views):
            radius = project(p, v, Precision("fp32"), alpha_min,
                             geometry_fn=model.geometry)["radius"]
            fold = torch.maximum(prev, radius)
            share = float((fold == held).float().mean())
            if best is None or share > best[1]:
                best = (i, share, fold)
    return best


def run_steps(p0: Dict[str, torch.Tensor], views: List[View], rc: dict, opt: dict,
              extent: float, arena_rows: int, order: List[int] = None,
              held: List[torch.Tensor] = None, precision: str = "fp32",
              fault: str = None, model: Model = GAUSSIANS) -> Followed:
    """Adam steps from p0, one view per step: the views of `order`, or
    those that `held` (the maximum screen radii after each step) identifies
    from this run's own state. rc: max_tiles, max_pairs, chunk,
    pair_capacity, adaptive_capacity, granule, alpha_min; opt: the
    OptimizationConfig values used."""
    prec = Precision(precision)
    names = model.leaves
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    lrs = model.lrs(opt)
    adam = torch.optim.Adam([{"params": [leaves[k]], "lr": lrs[k], "name": k}
                             for k in names], betas=(0.9, 0.999), eps=1e-15,
                            foreach=False)
    ctl = Controllers(rc, rc["granule"])
    n = p0["opacity"].shape[0]  # splats
    accum = torch.zeros(n, device=p0["opacity"].device)
    out_losses, first_grads = [], None
    steps = len(order) if order is not None else len(held)
    chosen, agree = [], []
    prev = torch.zeros(n, device=accum.device)
    for step in range(1, steps + 1):
        if order is not None:
            vi = order[step - 1]
        else:
            vi, share, prev = pick_view(leaves, views, prev, held[step - 1], rc["alpha_min"],
                                        model)
            agree.append(share)
        chosen.append(vi)
        view = views[vi]
        offset = torch.zeros((n, 2), device=accum.device, requires_grad=True)
        pr = project(leaves, view, prec, rc["alpha_min"], offset=offset,
                     geometry_fn=model.geometry)
        tab = bin_pairs(pr, ctl.rc, arena_rows)
        ch = composite(pr, model.features(leaves), tab, ctl.rc["chunk"], rc["alpha_min"],
                       view.width, view.height)
        rows = view.height // 2 if fault == "half_batch" else None
        total, photo = losses(ch, view, opt, prec, rows=rows)
        if model.regulariser is not None:
            total = total + model.regulariser(leaves, prec)
        (g_off,) = torch.autograd.grad(photo, offset, retain_graph=True)
        grads = torch.autograd.grad(total, [leaves[k] for k in names])
        vis = pr["valid"]
        if step == 1:
            accum = torch.where(vis, torch.linalg.vector_norm(g_off, dim=1), accum)
        for k, g in zip(names, grads):
            leaves[k].grad = g
        for group in adam.param_groups:
            if group["name"] == model.position:
                group["lr"] = expon_lr(step, opt["position_lr_init"] * extent,
                                       opt["position_lr_final"] * extent,
                                       opt["position_lr_max_steps"])
        adam.step()
        out_losses.append(total.item())
        if first_grads is None:
            first_grads = {k: g.detach() for k, g in zip(names, grads)}
            truncated, capped = tab.truncated, tab.capped
        ctl.update(tab, n)
        del pr, ch, total, photo, grads
    changes = {k: leaves[k].detach() - p0[k] for k in names}
    return Followed(Readout(out_losses, first_grads, changes, accum.detach()), chosen, agree,
                    truncated, capped)
