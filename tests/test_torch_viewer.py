"""The port's remote viewer server (`vegs_torch.viewer`, with
`scene.cameras.MiniCam`) against vegs_tpu's, on localhost.

The two round trips of tests/test_tools.py (a plain camera packet; the
byte-level SIBR client: a keep-alive, then a full packet with a
non-identity view matrix, the server's y/z column flips undoing the
client's) run against the port's server; and one scripted client session
against each package's server must receive the same bytes, exactly, and
hand the render function the same camera.
"""

import json
import socket
import threading
import time

import numpy as np
import torch

from vegs_torch.viewer import ViewerServer as TServer
from vegs_tpu.viewer import ViewerServer as JServer

H, W = 5, 7


def send_msg(c, payload):
    msg = json.dumps(payload).encode()
    c.sendall(len(msg).to_bytes(4, "little"))
    c.sendall(msg)


def recv_exact(c, n):
    buf = b""
    while len(buf) < n:
        chunk = c.recv(n - len(buf))
        assert chunk, "connection closed early"
        buf += chunk
    return buf


def camera_packet(view, **kw):
    return {"resolution_x": W, "resolution_y": H, "train": True,
            "fov_y": 0.8, "fov_x": 1.0, "z_near": 0.01, "z_far": 100.0,
            "shs_python": False, "rot_scale_python": False,
            "keep_alive": False, "scaling_modifier": 1.5,
            "view_matrix": list(view.flatten().astype(float)),
            "view_projection_matrix": list(view.flatten().astype(float)),
            **kw}


def session(server_cls, render_fn):
    """A scripted SIBR client: keep-alive, then a full camera packet.
    Returns (every byte received, the cameras and scales rendered)."""
    srv = server_cls(port=0)
    port = srv.listener.getsockname()[1]
    view = np.eye(4)
    view[3, :3] = [1.0, 2.0, 3.0]       # camera translation row (glm)
    view[:, 1] *= -1                    # undone by the server's flips
    view[:, 2] *= -1
    got = {}

    def client():
        c = socket.create_connection(("127.0.0.1", port))
        send_msg(c, {"resolution_x": 0, "resolution_y": 0})
        n = int.from_bytes(recv_exact(c, 4), "little")
        data = n.to_bytes(4, "little") + recv_exact(c, n)
        send_msg(c, camera_packet(view))
        data += recv_exact(c, H * W * 3)
        n = int.from_bytes(recv_exact(c, 4), "little")
        got["bytes"] = data + n.to_bytes(4, "little") + recv_exact(c, n)
        c.close()

    seen = []
    th = threading.Thread(target=client)
    th.start()
    for _ in range(400):
        srv.poll(lambda cam, s: (seen.append((cam, s)), render_fn(cam, s))[1],
                 source_path="model/path")
        if "bytes" in got:
            break
        time.sleep(0.02)
    th.join(timeout=10)
    srv.close()
    assert "bytes" in got, "the session never completed"
    return got["bytes"], seen


def red(cam, scale):
    img = np.zeros((cam.image_height, cam.image_width, 3), np.float32)
    img[..., 0] = 1.0
    img[1, 2] = [0.25, 0.5, 0.75]
    return img


def test_sibr_session_same_bytes_as_jax():
    tbytes, tseen = session(TServer, red)
    jbytes, jseen = session(JServer, red)
    assert tbytes == jbytes
    assert tbytes[4:14] == b"model/path"
    assert len(tseen) == len(jseen) == 1
    (tc, ts), (jc, js) = tseen[0], jseen[0]
    assert ts == js == 1.5
    for k in ("image_width", "image_height", "FoVy", "FoVx", "znear", "zfar"):
        assert getattr(tc, k) == getattr(jc, k)
    for k in ("world_view_transform", "full_proj_transform", "camera_center"):
        np.testing.assert_array_equal(getattr(tc, k), getattr(jc, k))
    np.testing.assert_allclose(tc.world_view_transform[:3, :3], np.eye(3),
                               atol=1e-12)
    np.testing.assert_allclose(tc.world_view_transform[3, :3], [1, 2, 3])


def test_tensor_image_on_the_wire():
    """A render function may return a tensor: the same bytes as numpy."""
    tbytes, _ = session(TServer, lambda cam, s: torch.from_numpy(red(cam, s)))
    nbytes, _ = session(TServer, red)
    assert tbytes == nbytes
    assert tbytes[14:17] == b"\xff\x00\x00"     # red, row-major RGB


def test_viewer_roundtrip():
    """tests/test_tools.py::test_viewer_roundtrip against the port."""
    srv = TServer(port=0)
    port = srv.listener.getsockname()[1]
    h, w = 4, 6
    result = {}

    def client():
        c = socket.create_connection(("127.0.0.1", port))
        send_msg(c, {
            "resolution_x": w, "resolution_y": h, "train": True,
            "fov_y": 0.8, "fov_x": 1.0, "z_near": 0.01, "z_far": 100.0,
            "keep_alive": False, "scaling_modifier": 1.0,
            "view_matrix": list(np.eye(4).flatten().astype(float)),
            "view_projection_matrix": list(np.eye(4).flatten().astype(float)),
        })
        result["image"] = recv_exact(c, h * w * 3)
        n = int.from_bytes(recv_exact(c, 4), "little")
        result["verify"] = recv_exact(c, n)
        c.close()

    th = threading.Thread(target=client)
    th.start()

    def render_fn(cam, scale):
        assert cam.image_width == w
        return np.full((h, w, 3), 0.5, np.float32)

    cont = None
    for _ in range(200):
        cont = srv.poll(render_fn, source_path="src")
        if result:
            break
        time.sleep(0.02)
    th.join(timeout=10)
    srv.close()
    assert result and cont is True
    assert result["image"][0] in (127, 128) and result["verify"] == b"src"


def test_minicam_matches_jax():
    from vegs_torch.scene.cameras import MiniCam as TMini
    from vegs_tpu.scene.cameras import MiniCam as JMini

    m = np.eye(4)
    m[:3, :3] = [[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    m[3, :3] = [0.5, -1.0, 2.0]
    t = TMini(8, 6, 0.7, 0.9, 0.01, 50.0, m, m)
    j = JMini(8, 6, 0.7, 0.9, 0.01, 50.0, m, m)
    np.testing.assert_array_equal(t.camera_center, j.camera_center)
    np.testing.assert_allclose(t.camera_center, np.linalg.inv(m)[3, :3])
