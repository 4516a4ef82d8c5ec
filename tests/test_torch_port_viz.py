"""Port parity, the views and the viewer: hairgs_tpu_torch.visualization and
hairgs_tpu_torch.network_gui against hairgs_tpu's on the cases of
tests/test_aux.py (the SIBR protocol round trip over a local socket, the
grid compositor, the HSV map, the PLY writers) and tests/test_viz3d.py
(the pyvista plotters against the same recording fake), plus the render
dictionary of a small model and the grid's bitmap labels without cv2.

Tolerances: grids, HSV maps, PLY bytes, frustum segments, viewpoint calls
and plotted arrays equal to JAX's (1e-6 where a camera matrix is inverted
in float64 from the same float32 entries); the rendered dictionaries
within 1 of 255 per pixel.
"""

import builtins
import json
import math
import socket
import threading
import time

import numpy as np
import pytest
import torch

from tests.test_torch_port_topo import make_pair, two_strands
from tests.test_viz3d import FakeCamera, FakePlotter, FakePolyData, FakePV  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and the
    idle OpenMP threads of a torch pool spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ring_cameras(angle, dist=0.3):
    """tests/test_viz3d.py::ring_camera in both packages."""
    from hairgs_tpu.core.camera import make_camera as jmake
    from hairgs_tpu_torch.core.camera import make_camera

    R = np.array([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                  [-np.sin(angle), 0, np.cos(angle)]])
    t = np.array([0.0, 0.0, dist])
    return (jmake(R, t, fovx=0.9, fovy=0.8),
            make_camera(R, t, fovx=0.9, fovy=0.8, device="cpu"))


def test_protocol_roundtrip():
    from hairgs_tpu_torch.network_gui import NetworkGUI

    gui = NetworkGUI()
    assert gui.listener is None  # no socket until init
    gui.init("127.0.0.1", 0)
    port = gui.listener.getsockname()[1]
    received = {}

    def client():
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.settimeout(10)
        view = np.arange(16, dtype=float).reshape(4, 4) * 0.1 + np.eye(4)
        msg = {
            "resolution_x": 64, "resolution_y": 48, "train": True,
            "fov_y": 0.8, "fov_x": 1.0, "z_near": 0.01, "z_far": 100.0,
            "shs_python": False, "rot_scale_python": False,
            "keep_alive": True, "scaling_modifier": 1.0,
            "view_matrix": list(view.flatten()),
            "view_projection_matrix": list(np.eye(4).flatten().astype(float)),
        }
        payload = json.dumps(msg).encode()
        s.sendall(len(payload).to_bytes(4, "little") + payload)
        img = b""
        want = 64 * 48 * 3
        while len(img) < want:
            img += s.recv(want - len(img))
        vlen = int.from_bytes(s.recv(4), "little")
        received["verify"] = s.recv(vlen).decode()
        received["img_len"] = len(img)
        received["view"] = view
        s.close()

    th = threading.Thread(target=client, daemon=True)
    th.start()
    try:
        for _ in range(200):
            gui.try_connect()
            if gui.conn is not None:
                break
            time.sleep(0.02)
        assert gui.conn is not None
        gui.conn.settimeout(10)
        cam, do_training, shs, rot, keep_alive, mod = gui.receive()
        assert (cam.width, cam.height, do_training, keep_alive, mod) == (64, 48, True, True, 1.0)
        gui.send(bytes(64 * 48 * 3), "test-path")
        th.join(timeout=5)
    finally:
        gui.close()
    assert not th.is_alive()
    assert received["verify"] == "test-path" and received["img_len"] == 64 * 48 * 3
    # the transposed view with flipped y/z columns, in math convention
    want = received["view"].astype(np.float32).copy()
    want[:, 1:3] *= -1
    np.testing.assert_array_equal(cam.world_view, want.T)
    c = cam.to_camera("cpu")
    np.testing.assert_array_equal(c.world_view.numpy(), want.T)
    assert c.tanfovx.item() == pytest.approx(math.tan(0.5), abs=1e-7)
    assert gui.listener is None and gui.conn is None


def test_grid_hsv_and_ply_writers_match_jax(tmp_path):
    from hairgs_tpu import visualization as jv
    from hairgs_tpu_torch import visualization as tv

    imgs = {"a": np.full((32, 32, 3), 100, np.uint8),
            "b": np.full((16, 48), 200, np.uint8),
            "c": np.random.default_rng(0).integers(0, 256, (20, 30, 3), np.uint8)}
    grid = tv.create_subplots_from_dict(imgs, image_w=256, image_h=128)
    assert grid.shape == (128, 256, 3) and grid.max() >= 100
    np.testing.assert_array_equal(grid, jv.create_subplots_from_dict(imgs, 256, 128))
    np.testing.assert_array_equal(tv.create_subplots_from_dict({}, 64, 32),
                                  jv.create_subplots_from_dict({}, 64, 32))
    theta = np.linspace(0, np.pi - 1e-3, 64).reshape(8, 8)
    mask = (np.arange(64).reshape(8, 8) % 3 > 0).astype(np.float32)
    for m in (None, mask):
        rgb = tv.orientation_map_to_hsv(theta, m)
        assert rgb.shape == (8, 8, 3) and rgb.min() >= 0 and rgb.max() <= 1
        np.testing.assert_array_equal(rgb, jv.orientation_map_to_hsv(theta, m))
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (5, 3)).astype(np.uint8)
    edges = np.array([[0, 1], [1, 2], [3, 4]])
    for name, args in (("save_ply_edges", (pts, cols, edges)),
                       ("save_ply_edges", (pts, cols, None)),
                       ("save_ply_faces", (pts, cols, edges))):
        getattr(tv, name)(*args, str(tmp_path / "t.ply"))
        getattr(jv, name)(*args, str(tmp_path / "j.ply"))
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_grid_labels_without_cv2(monkeypatch):
    """Without cv2 the grid resizes by nearest sampling, as JAX does, and
    draws its labels in the 5x7 bitmap font (white pixels inside each
    label's box only)."""
    from hairgs_tpu_torch import visualization as tv

    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *a, **k)

    imgs = {"0-render": np.zeros((40, 40, 3), np.uint8),
            "0-gt": np.zeros((40, 40, 3), np.uint8)}
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    grid = tv.create_subplots_from_dict(imgs, image_w=120, image_h=60)
    monkeypatch.undo()
    white = np.argwhere(grid.max(axis=2) == 255)
    assert white.size
    # "0-render" in the first cell (x0 4, y0 4, 6 px per character), "0-gt"
    # in the second (x0 64)
    assert white[:, 0].min() >= 4 and white[:, 0].max() < 11
    first = white[white[:, 1] < 60]
    second = white[white[:, 1] >= 60]
    assert first[:, 1].max() < 4 + 6 * 8 and second[:, 1].min() >= 64
    assert second[:, 1].max() < 64 + 6 * 4


def test_render_dictionary_matches_jax():
    from hairgs_tpu import visualization as jv
    from hairgs_tpu_torch import visualization as tv

    eps, pairs = two_strands()
    jm, tm = make_pair(eps * 5 + np.float32([0, 0, 0.0]), pairs, width=2e-3)
    jcams, tcams = zip(*(ring_cameras(a) for a in (0.0, 1.0)))
    # cameras need images for their sizes: 48 x 40 grey views
    img = np.full((40, 48, 3), 0.5, np.float32)
    jcams = [c._replace(image=np.asarray(img)) for c in jcams]
    tcams = [c._replace(image=torch.from_numpy(img)) for c in tcams]
    dj = jv.render_image_dict_from_cameras(jm, jcams)
    dt = tv.render_image_dict_from_cameras(tm, tcams)
    assert list(dt) == list(dj) == ["0-render", "0-gt", "1-render", "1-gt"]
    for k in dj:
        assert dt[k].dtype == np.uint8 and dt[k].shape == dj[k].shape == (40, 48, 3)
        assert np.abs(dt[k].astype(int) - dj[k].astype(int)).max() <= 1, k
    assert dt["0-render"].max() > 0


def test_pv_visualize_matches_jax():
    from hairgs_tpu import visualization as jv
    from hairgs_tpu_torch import visualization as tv

    pts = np.random.default_rng(0).normal(0, 1, (10, 3)).astype(np.float32)
    plotter = tv.pv_visualize(point_clouds={"blue": torch.from_numpy(pts)},
                              title="t", pv=FakePV())
    jplotter = jv.pv_visualize(point_clouds={"blue": pts}, title="t", pv=FakePV())
    assert plotter.shown and plotter.rendered and plotter.texts == jplotter.texts
    (got, kw), (jgot, jkw) = plotter.points[0], jplotter.points[0]
    np.testing.assert_array_equal(got, jgot)
    assert kw == jkw == {"color": "blue", "point_size": 1, "opacity": 1}
    p = FakePlotter()
    tv.pv_visualize(plotter=p, lines={"white": np.zeros((4, 3), np.float32)},
                    title="step", pv=FakePV())
    assert p.texts == ["step"] and not p.shown
    assert p.lines[0][1]["color"] == "white"


def test_frustums_and_viewpoints_match_jax():
    from hairgs_tpu import visualization as jv
    from hairgs_tpu_torch import visualization as tv

    for angle in (0.7, 1.1):
        jc, tc = ring_cameras(angle)
        segs = tv.camera_frustum_lines(tc, scale=0.1)
        assert segs.shape == (16, 3)
        np.testing.assert_allclose(segs, jv.camera_frustum_lines(jc, scale=0.1),
                                   rtol=0, atol=1e-6)
        p, jp = FakePlotter(), FakePlotter()
        tv.make_viewpoint_setter(p, tc)()
        jv.make_viewpoint_setter(jp, jc)()
        assert p.camera.calls.keys() == jp.camera.calls.keys()
        for k in jp.camera.calls:
            np.testing.assert_allclose(p.camera.calls[k][0], jp.camera.calls[k][0],
                                       rtol=0, atol=1e-6, err_msg=k)


def test_background_plotter_polydata_and_merge_viz_match_jax():
    from hairgs_tpu import visualization as jv
    from hairgs_tpu_torch import visualization as tv

    eps, pairs = two_strands()
    jm, tm = make_pair(eps, pairs)
    jcams, tcams = zip(*(ring_cameras(a) for a in (0.0, 1.0, 2.0)))
    plotter, polydata = tv.create_pv_background_plotter(tm, tcams, pv=FakePV())
    jplotter, jpolydata = jv.create_pv_background_plotter(jm, jcams, pv=FakePV())
    np.testing.assert_array_equal(polydata.points, jpolydata.points)
    np.testing.assert_array_equal(polydata.lines, jpolydata.lines)
    assert set(plotter.key_events) == set(jplotter.key_events) == {"1", "2", "3"}
    assert len(plotter.lines) == 3
    plotter.key_events["2"]()
    jplotter.key_events["2"]()
    np.testing.assert_allclose(plotter.camera.calls["SetPosition"][0],
                               jplotter.camera.calls["SetPosition"][0], atol=1e-6)
    pd, jpd = FakePolyData(), FakePolyData()
    tv.update_polydata_from_hair(pd, tm)
    jv.update_polydata_from_hair(jpd, jm)
    assert pd.points.shape == (6, 3) and pd.lines.shape == (3 * len(pairs),)
    np.testing.assert_array_equal(pd.lines, jpd.lines)

    made = []

    class RecordingPV(FakePV):
        class Plotter(FakePlotter):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)

    cand = np.asarray([[2, 3]])
    tv.make_merge_viz_callback(tm, pv=RecordingPV())(1, cand)
    jv.make_merge_viz_callback(jm, pv=RecordingPV())(1, cand)
    (p, jp) = made
    assert p.shown and p.background == jp.background == "black"
    white = [line for line, k in p.lines if k.get("color") == "white"]
    jwhite = [line for line, k in jp.lines if k.get("color") == "white"]
    np.testing.assert_array_equal(white[0], jwhite[0])
    np.testing.assert_allclose(white[0], eps[[2, 3]], atol=1e-6)


def test_merge_loop_viz_callback_sees_pre_merge_pairs():
    """stage2_merge_loop calls viz_callback before each merge with pairs
    that index the pre-merge endpoints, as JAX's loop does."""
    from hairgs_tpu.topo.merge import stage2_merge_loop as jloop
    from hairgs_tpu_torch.topo.merge import stage2_merge_loop

    jm, tm = make_pair(*two_strands())
    seen, jseen = [], []
    n = stage2_merge_loop(tm, 10, viz_callback=lambda i, p: seen.append((i, p.copy())))
    jn = jloop(jm, max_iterations=10, viz_callback=lambda i, p: jseen.append((i, p.copy())))
    assert n == jn == 1 and len(seen) == len(jseen) == 1
    assert seen[0][0] == 1
    np.testing.assert_array_equal(seen[0][1], jseen[0][1])
