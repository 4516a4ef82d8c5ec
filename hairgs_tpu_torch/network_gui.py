"""Live-viewer network GUI, the SIBR remote-viewer protocol (counterpart of
hairgs_tpu/network_gui.py).

Parity target: gaussian_renderer/network_gui.py — a non-blocking TCP server:
length-prefixed JSON messages in (resolution, fov, near/far, view and
view-projection matrices with flipped y/z columns, training toggle, python
toggles, scaling modifier), raw RGB bytes and a length-prefixed verify
string out.

The incoming matrices are in the reference's transposed right-multiply
convention; they are converted to this package's math convention
(M @ [p, 1]) on receipt. The listening socket is opened by `init` and
closed by `close`, not when the module is imported.
"""

import json
import math
import socket
import traceback
from typing import NamedTuple, Optional

import numpy as np


class MiniCam(NamedTuple):
    """Viewer-supplied camera (scene/cameras.py:111-132 equivalent)."""

    width: int
    height: int
    fovy: float
    fovx: float
    znear: float
    zfar: float
    world_view: np.ndarray  # (4,4) math convention
    full_proj: np.ndarray  # (4,4)
    cam_center: np.ndarray  # (3,)

    def to_camera(self, device="cuda"):
        """The renderer's Camera on `device` (no images)."""
        import torch

        from hairgs_tpu_torch import resolve_device
        from hairgs_tpu_torch.core.camera import Camera

        dev = resolve_device(device)

        def f32(x):
            return torch.tensor(np.asarray(x, dtype=np.float32), device=dev)

        return Camera(
            world_view=f32(self.world_view),
            full_proj=f32(self.full_proj),
            cam_center=f32(self.cam_center),
            tanfovx=f32(math.tan(self.fovx * 0.5)),
            tanfovy=f32(math.tan(self.fovy * 0.5)),
        )


class NetworkGUI:
    def __init__(self):
        self.host = "127.0.0.1"
        self.port = 6009
        self.conn: Optional[socket.socket] = None
        self.addr = None
        self.listener: Optional[socket.socket] = None

    def init(self, host: str, port: int):
        """Listen on (host, port) without blocking; raises OSError when the
        address cannot be bound."""
        self.host, self.port = host, port
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            listener.bind((host, port))
            listener.listen()
            listener.settimeout(0)
        except OSError:
            listener.close()
            raise
        self.listener = listener

    def close(self):
        for s in (self.conn, self.listener):
            if s is not None:
                s.close()
        self.conn = self.listener = None

    def try_connect(self):
        try:
            self.conn, self.addr = self.listener.accept()
            print(f"\nConnected by {self.addr}")
            self.conn.settimeout(None)
        except (BlockingIOError, OSError):
            pass

    def _read(self):
        length = int.from_bytes(self.conn.recv(4), "little")
        payload = b""
        while len(payload) < length:
            chunk = self.conn.recv(length - len(payload))
            if not chunk:
                raise ConnectionError("viewer closed connection")
            payload += chunk
        return json.loads(payload.decode("utf-8"))

    def send(self, image_bytes: Optional[bytes], verify: str):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def receive(self):
        """Returns (MiniCam|None, do_training, shs_python, rot_scale_python,
        keep_alive, scaling_modifier)."""
        message = self._read()
        width = message["resolution_x"]
        height = message["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None, None, None
        try:
            do_training = bool(message["train"])
            fovy = message["fov_y"]
            fovx = message["fov_x"]
            znear = message["z_near"]
            zfar = message["z_far"]
            shs_python = bool(message["shs_python"])
            rot_scale_python = bool(message["rot_scale_python"])
            keep_alive = bool(message["keep_alive"])
            scaling_modifier = message["scaling_modifier"]
            # the viewer sends transposed matrices with flipped y/z columns
            wv_t = np.asarray(message["view_matrix"], dtype=np.float32).reshape(4, 4)
            wv_t[:, 1] *= -1
            wv_t[:, 2] *= -1
            fp_t = np.asarray(
                message["view_projection_matrix"], dtype=np.float32
            ).reshape(4, 4)
            fp_t[:, 1] *= -1
            fp_t[:, 2] *= -1
            world_view = wv_t.T  # to math convention
            full_proj = fp_t.T
            cam_center = np.linalg.inv(world_view)[:3, 3]
            cam = MiniCam(width, height, fovy, fovx, znear, zfar,
                          world_view, full_proj, cam_center)
        except Exception:
            print("")
            traceback.print_exc()
            raise
        return (cam, do_training, shs_python, rot_scale_python, keep_alive,
                scaling_modifier)
