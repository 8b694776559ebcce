"""Remote viewer server speaking the 3DGS SIBR wire format (port of
vegs_tpu/viewer.py).

A non-blocking TCP server: each message from the viewer is a 4-byte
little-endian length and a JSON camera/toggle packet; the answer is the
rendered image as raw row-major RGB bytes (none for a zero-resolution
keep-alive packet), then a 4-byte length and the verify string (the
source path). Opt-in inside a training loop:

    viewer = ViewerServer(host, port)
    ...
    keep_training = viewer.poll(render_fn, source_path=...)

`render_fn(MiniCam, scaling_modifier)` returns an [H, W, 3] float image in
[0, 1] (a numpy array, or a tensor on any device) or None.
"""

from __future__ import annotations

import json
import socket
import traceback
from typing import Callable, Optional

import numpy as np

from .scene.cameras import MiniCam


class ViewerServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None
        self.addr = None

    def try_connect(self) -> None:
        try:
            self.conn, self.addr = self.listener.accept()
            self.conn.settimeout(None)
        except OSError:
            pass

    def _read(self) -> dict:
        length = int.from_bytes(self.conn.recv(4), "little")
        return json.loads(self.conn.recv(length).decode("utf-8"))

    def receive_camera(self):
        """One message -> (MiniCam or None, do_training, keep_alive,
        scaling_modifier); the view matrices' y and z columns flipped from
        the viewer's convention into the repo's."""
        message = self._read()
        width = message["resolution_x"]
        height = message["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None
        try:
            world_view = np.reshape(np.array(message["view_matrix"]), (4, 4))
            world_view[:, 1] = -world_view[:, 1]
            world_view[:, 2] = -world_view[:, 2]
            full_proj = np.reshape(
                np.array(message["view_projection_matrix"]), (4, 4))
            full_proj[:, 1] = -full_proj[:, 1]
            cam = MiniCam(width, height, message["fov_y"], message["fov_x"],
                          message["z_near"], message["z_far"], world_view,
                          full_proj)
        except Exception:
            traceback.print_exc()
            raise
        return (cam, bool(message["train"]), bool(message["keep_alive"]),
                message["scaling_modifier"])

    def send(self, image_bytes: Optional[bytes], verify: str) -> None:
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def poll(self, render_fn: Callable, source_path: str = "",
             keep_training: bool = True) -> bool:
        """Serve the viewer until a camera packet asks to train or lets the
        connection lapse; returns whether training should go on."""
        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                cam, do_training, keep_alive, scale_mod = self.receive_camera()
                img_bytes = None
                if cam is not None:
                    img = render_fn(cam, scale_mod)
                    if img is not None:
                        if hasattr(img, "detach"):
                            img = img.detach().cpu().numpy()
                        img_bytes = memoryview(
                            (np.clip(img, 0, 1) * 255).astype(np.uint8)
                        ).tobytes()
                self.send(img_bytes, source_path)
                # a zero-resolution packet is a keep-alive: go on serving
                if cam is not None and (do_training or not keep_alive):
                    return bool(do_training)
            except Exception:
                self.conn = None
        return keep_training

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()
        self.listener.close()
