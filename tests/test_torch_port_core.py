"""Port parity, core math: hairgs_tpu_torch against hairgs_tpu on the CPU.

The same numpy inputs (from a seed) go through the JAX function and its
PyTorch counterpart. Values agree to rtol 1e-5 (float32 evaluated in
another order), gradients to 3e-3 x max |g|.
"""

import ast
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_render import HEIGHT, WIDTH, make_scene

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
RTOL = 1e-5


def _t(x, requires_grad=False):
    return torch.tensor(np.asarray(x), requires_grad=requires_grad)


def _close(a, b, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a) else a),
                               np.asarray(b), rtol=rtol, atol=atol)


def _grad_close(gt, gj):
    gj = np.asarray(gj)
    scale = max(np.abs(gj).max(), 1e-12)
    np.testing.assert_allclose(gt.detach().numpy(), gj, atol=3e-3 * scale, rtol=0)


def _torch_camera(cam):
    from hairgs_tpu_torch.models.gaussian import camera_from_numpy

    return camera_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in cam._asdict().items()},
        CPU)


def test_build_rotation():
    from hairgs_tpu.core.transforms import build_rotation as jrot
    from hairgs_tpu.core.transforms import build_scaling_rotation as jsrot
    from hairgs_tpu_torch.core.transforms import (
        build_rotation,
        build_scaling_rotation,
        strip_symmetric,
    )

    q = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    q[0] = 0.0  # a pad row: zero quaternion
    _close(build_rotation(_t(q)), jrot(jnp.asarray(q)))
    s = np.random.default_rng(2).uniform(0.01, 1.0, (64, 3)).astype(np.float32)
    _close(build_scaling_rotation(_t(s), _t(q)), jsrot(jnp.asarray(s), jnp.asarray(q)))
    cov = np.random.default_rng(1).normal(size=(5, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(strip_symmetric(_t(cov)).numpy(),
                                  cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]])


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh(deg):
    from hairgs_tpu.core.sh import eval_sh as jsh
    from hairgs_tpu_torch.core.sh import RGB2SH, SH2RGB, eval_sh

    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(40, 3, 16)).astype(np.float32)
    d = rng.normal(size=(40, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    _close(eval_sh(deg, _t(sh), _t(d)), jsh(deg, jnp.asarray(sh), jnp.asarray(d)))
    rgb = rng.uniform(size=(8, 3)).astype(np.float32)
    _close(SH2RGB(RGB2SH(_t(rgb))), rgb)


def test_expon_lr():
    from hairgs_tpu.core.schedules import expon_lr as jlr
    from hairgs_tpu_torch.core.schedules import expon_lr

    for step in (-1, 0, 1, 777, 15000, 30000, 40000):
        for kw in (dict(), dict(lr_delay_steps=100, lr_delay_mult=0.01)):
            _close(expon_lr(step, 1.6e-4, 1.6e-6, max_steps=30000, **kw),
                   jlr(step, 1.6e-4, 1.6e-6, max_steps=30000, **kw), atol=0)
    assert float(expon_lr(5, 0.0, 0.0)) == 0.0


def test_maths_and_focal_helpers():
    from hairgs_tpu.core.camera import focal2fov as jf2f
    from hairgs_tpu.core.camera import fov2focal as jfov
    from hairgs_tpu.core.maths import inverse_sigmoid as jinv
    from hairgs_tpu.core.maths import safe_norm as jnorm
    from hairgs_tpu_torch.core.camera import focal2fov, fov2focal
    from hairgs_tpu_torch.core.maths import inverse_sigmoid, safe_norm

    x = np.random.default_rng(3).uniform(0.01, 0.99, (17,)).astype(np.float32)
    _close(inverse_sigmoid(_t(x)), jinv(jnp.asarray(x)))
    v = np.random.default_rng(4).normal(size=(9, 3)).astype(np.float32)
    v[0] = 0.0  # the origin: zero gradient, not NaN
    tv = _t(v, True)
    safe_norm(tv, dim=-1).sum().backward()
    _close(safe_norm(_t(v), dim=-1), jnorm(jnp.asarray(v), axis=-1))
    _close(tv.grad, jax.grad(lambda a: jnorm(a, axis=-1).sum())(jnp.asarray(v)))
    assert float(tv.grad[0].abs().sum()) == 0.0
    assert fov2focal(1.2, 999) == jfov(1.2, 999)
    assert focal2fov(850.0, 1000) == jf2f(850.0, 1000)


def test_camera_matrices():
    from hairgs_tpu.core.camera import make_camera as jcam
    from hairgs_tpu_torch.core.camera import make_camera

    angle = 0.7
    R = np.array([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                  [-np.sin(angle), 0, np.cos(angle)]])
    t = np.array([0.1, -0.2, 3.0])
    img = np.random.default_rng(0).uniform(size=(6, 5, 3)).astype(np.float32)
    cj = jcam(R, t, fovx=1.2, fovy=1.0, image=img)
    ct = make_camera(R, t, fovx=1.2, fovy=1.0, image=img, device="cpu")
    for name in ("world_view", "full_proj", "cam_center", "tanfovx", "tanfovy", "image"):
        np.testing.assert_array_equal(getattr(ct, name).numpy(),
                                      np.asarray(getattr(cj, name)))
    assert (ct.height, ct.width) == (6, 5)


def test_resolve_device_never_falls_back(monkeypatch):
    import hairgs_tpu_torch
    from hairgs_tpu_torch.core.camera import make_camera

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_camera(np.eye(3), np.zeros(3), 1.0, 1.0)
    assert hairgs_tpu_torch.resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("antialiasing", [False, True])
def test_preprocess_values_and_grads(antialiasing):
    from hairgs_tpu.render.preprocess import preprocess as jprep
    from hairgs_tpu_torch.render.preprocess import preprocess

    cam, args = make_scene(n=60)
    means, scales, q, opacity, _ = [np.asarray(a) for a in args]
    # compiled programs: far quicker on the CPU than op-by-op dispatch
    pj = jax.jit(lambda m, s, qq: jprep(
        m, s, qq, cam, WIDTH, HEIGHT, 16, opacity=jnp.asarray(opacity),
        antialiasing=antialiasing))(jnp.asarray(means), jnp.asarray(scales),
                                    jnp.asarray(q))
    tm, ts, tq = _t(means, True), _t(scales, True), _t(q, True)
    pt = preprocess(tm, ts, tq, _torch_camera(cam), WIDTH, HEIGHT, 16,
                    opacity=_t(opacity), antialiasing=antialiasing)
    for name in ("valid", "rect", "tiles_touched"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(pj, name)), err_msg=name)
    for name in ("depth", "xy", "conic", "radius", "cull_radius"):
        _close(getattr(pt, name), getattr(pj, name), atol=1e-5)

    rng = np.random.default_rng(5)
    wx = rng.normal(size=(60, 2)).astype(np.float32)
    wc = rng.normal(size=(60, 3)).astype(np.float32)

    def jloss(m, s, qq):
        p = jprep(m, s, qq, cam, WIDTH, HEIGHT, 16, opacity=jnp.asarray(opacity),
                  antialiasing=antialiasing)
        out = jnp.sum(p.xy * wx) + jnp.sum(p.conic * wc)
        return out + (jnp.sum(p.compensation) if antialiasing else 0.0)

    gj = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(q))
    lt = torch.sum(pt.xy * _t(wx)) + torch.sum(pt.conic * _t(wc))
    if antialiasing:
        lt = lt + torch.sum(pt.compensation)
    lt.backward()
    for gt, g in zip((tm.grad, ts.grad, tq.grad), gj):
        _grad_close(gt, g)


def test_preprocess_pad_rows_on_camera_plane_have_finite_grads():
    """Zero pad rows at the world origin lie on this camera's plane
    (tz = 0): the tz > 0.19 guard keeps their gradients finite."""
    from hairgs_tpu_torch.core.camera import make_camera
    from hairgs_tpu_torch.render.preprocess import preprocess

    cam = make_camera(np.eye(3), np.zeros(3), fovx=1.2, fovy=1.0, device="cpu")
    rng = np.random.default_rng(0)
    means = np.zeros((8, 3), np.float32)
    means[:4] = rng.uniform(-0.5, 0.5, (4, 3))
    means[:4, 2] = 3.0
    scales = np.full((8, 3), 0.05, np.float32)
    q = np.zeros((8, 4), np.float32)
    q[:4, 0] = 1.0
    tm, ts, tq = _t(means, True), _t(scales, True), _t(q, True)
    p = preprocess(tm, ts, tq, cam, WIDTH, HEIGHT, 16, active=_t(np.arange(8) < 4),
                   opacity=_t(np.full(8, 0.5, np.float32)))
    assert not p.valid[4:].any()
    (p.xy.sum() + p.conic.sum()).backward()
    for g in (tm.grad, ts.grad, tq.grad):
        assert torch.isfinite(g).all()


def test_ssim_and_l1():
    from hairgs_tpu.losses.photometric import l1_loss as jl1
    from hairgs_tpu.ops.ssim import ssim as jssim
    from hairgs_tpu_torch.losses.photometric import l1_loss, psnr
    from hairgs_tpu_torch.ops.ssim import ssim

    rng = np.random.default_rng(0)
    a = rng.uniform(size=(37, 29, 3)).astype(np.float32)
    b = rng.uniform(size=(37, 29, 3)).astype(np.float32)
    ta = _t(a, True)
    s = ssim(ta, _t(b))
    _close(s, jssim(jnp.asarray(a), jnp.asarray(b)))
    _close(l1_loss(_t(a), _t(b)), jl1(jnp.asarray(a), jnp.asarray(b)))
    assert math.isclose(float(psnr(_t(a), _t(a))), 120.0, rel_tol=1e-6)
    s.backward()
    _grad_close(ta.grad, jax.grad(lambda x: jssim(x, jnp.asarray(b)))(jnp.asarray(a)))


def test_bce_and_orientation_loss():
    from hairgs_tpu.losses.photometric import (
        mask_loss_from_channel as jmask,
        orientation_loss_from_channels as jorient,
    )
    from hairgs_tpu_torch.losses.photometric import (
        mask_loss_from_channel,
        orientation_loss_from_channels,
    )

    rng = np.random.default_rng(1)
    h, w = 12, 10
    m = rng.uniform(size=(h, w)).astype(np.float32)
    m[:3] = 0.0  # uncovered pixels: the maximum's tie at 0
    gt = (rng.uniform(size=(h, w)) > 0.5).astype(np.float32)
    tmk = _t(m, True)
    lm = mask_loss_from_channel(tmk, _t(gt))
    _close(lm, jmask(jnp.asarray(m), jnp.asarray(gt)))
    lm.backward()
    _grad_close(tmk.grad, jax.grad(lambda x: jmask(x, jnp.asarray(gt)))(jnp.asarray(m)))

    cam, _ = make_scene(n=4)
    o = rng.normal(size=(h, w, 3)).astype(np.float32)
    cam = cam._replace(
        orientation=jnp.asarray(rng.uniform(0, np.pi, (h, w)).astype(np.float32)),
        confidence=jnp.asarray(rng.uniform(size=(h, w)).astype(np.float32)),
        mask=jnp.asarray(gt))
    to = _t(o, True)
    lo = orientation_loss_from_channels(to, _torch_camera(cam))
    _close(lo, jorient(jnp.asarray(o), cam))
    lo.backward()
    _grad_close(to.grad, jax.grad(lambda x: jorient(x, cam))(jnp.asarray(o)))


def test_adam_step():
    from hairgs_tpu.optim import adam_init as jinit
    from hairgs_tpu.optim import adam_step as jstep
    from hairgs_tpu_torch.optim import adam_init, adam_step
    from typing import NamedTuple

    class P(NamedTuple):
        a: object
        b: object

    rng = np.random.default_rng(2)
    p = P(rng.normal(size=(5, 3)).astype(np.float32),
          rng.normal(size=(7,)).astype(np.float32))
    pj, pt = P(*map(jnp.asarray, p)), P(*map(_t, p))
    sj, st = jinit(pj), adam_init(pt)
    for i in range(3):
        g = P(rng.normal(size=(5, 3)).astype(np.float32),
              rng.normal(size=(7,)).astype(np.float32))
        lr = P(1e-2, 0.05)
        pj, sj = jstep(pj, P(*map(jnp.asarray, g)), sj, lr)
        pt, st = adam_step(pt, P(*map(_t, g)), st, lr)
    for a, b in zip(pt + st.mu + st.nu, pj + sj.mu + sj.nu):
        _close(a, b)
    assert int(st.step) == int(sj.step) == 3


def _imports(path):
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "hairgs_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 16
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "hairgs_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad
