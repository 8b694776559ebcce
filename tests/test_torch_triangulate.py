"""The port's known-pose triangulation tool (`vegs_torch.tools.triangulate`)
against vegs_tpu's, on the toy KITTI-360 segment
(`tests/test_torch_loaders.toy_kitti360_root`) with seeded semantic label
images (one frame without labels).

There is no COLMAP binary here: a stub `colmap` script records its argv
and, at `model_converter`, writes a seeded cloud (with far outliers) as
the triangulated points3D.ply. Each package runs the whole tool on its own
copy of the root; the text models, the masks, the argv (root prefix
replaced) and the filtered cloud must be equal, byte for byte or to the
bit. `statistical_outlier_filter` alone: the same kept points as JAX's.
"""

import json
import os
import stat
import sys

import numpy as np
from PIL import Image

from tests.test_torch_loaders import SEQ, START, toy_kitti360_root
from vegs_torch.scene import dataset_readers as tread
from vegs_torch.tools import triangulate as ttri
from vegs_tpu.tools import triangulate as jtri

STUB = '''#!{python}
import json, os, sys
import numpy as np
with open(os.environ["COLMAP_STUB_LOG"], "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
if sys.argv[1] == "model_converter":
    out = sys.argv[sys.argv.index("--output_path") + 1]
    d = np.load(os.environ["COLMAP_STUB_CLOUD"])
    n = len(d["xyz"])
    rec = np.empty(n, [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                       ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    for i, k in enumerate("xyz"):
        rec[k] = d["xyz"][:, i]
    for i, k in enumerate(("red", "green", "blue")):
        rec[k] = d["rgb"][:, i]
    head = ("ply\\nformat binary_little_endian 1.0\\nelement vertex %d\\n"
            "property float x\\nproperty float y\\nproperty float z\\n"
            "property uchar red\\nproperty uchar green\\nproperty uchar blue\\n"
            "end_header\\n" % n)
    with open(out, "wb") as f:
        f.write(head.encode() + rec.tobytes())
'''


def cloud(seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(400, 3)).astype(np.float32)
    xyz[:8] *= 40.0                          # far outliers
    return xyz, rng.integers(0, 256, (400, 3)).astype(np.uint8)


def write_semantics(root, frames, seed=0):
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "data_2d_semantics", "train", SEQ, "image_00",
                     "semantic")
    os.makedirs(d, exist_ok=True)
    for f in frames:
        Image.fromarray(rng.integers(0, 45, (48, 64)).astype(np.uint8)).save(
            os.path.join(d, f"{f:010d}.png"))


def test_triangulate_segment_matches_jax(tmp_path, monkeypatch):
    xyz, rgb = cloud()
    np.savez(tmp_path / "cloud.npz", xyz=xyz, rgb=rgb)
    stub = tmp_path / "colmap"
    stub.write_text(STUB.format(python=sys.executable))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("COLMAP_STUB_CLOUD", str(tmp_path / "cloud.npz"))
    runs = {}
    for name, mod in (("jax", jtri), ("port", ttri)):
        root = toy_kitti360_root(tmp_path / name / "root")
        write_semantics(root, [START + 1, START + 2, START + 3])
        log = tmp_path / name / "argv.jsonl"
        monkeypatch.setenv("COLMAP_STUB_LOG", str(log))
        ply = mod.triangulate_segment(root, SEQ, START, START + 4,
                                      colmap_bin=str(stub))
        argv = [json.loads(x) for x in log.read_text().splitlines()]
        runs[name] = (root, ply, argv)
    (jroot, jply, jargv), (troot, tply, targv) = runs["jax"], runs["port"]
    assert tply.replace(troot, jroot) == jply
    assert [c[0] for c in targv] == ["feature_extractor", "exhaustive_matcher",
                                     "point_triangulator", "model_converter"]
    assert [[a.replace(troot, jroot) for a in c] for c in targv] == jargv
    seg = f"{START:010d}_{START + 4:010d}"
    work = os.path.join("data_3d_colmap_processed", "train", SEQ, "static",
                        seg, "work")
    files = []
    for dirpath, _, names in os.walk(os.path.join(troot, work)):
        files += [os.path.join(dirpath, n) for n in names]
    rel = sorted(os.path.relpath(f, troot) for f in files)
    assert sorted(r for r in rel if "masks" in r) == [
        os.path.join(work, "masks", f"{f:010d}.png.png")
        for f in (START + 1, START + 2, START + 3)]
    for r in rel:
        with open(os.path.join(troot, r), "rb") as a, \
                open(os.path.join(jroot, r), "rb") as b:
            if r.endswith(".png"):
                np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                              np.asarray(Image.open(b)))
            else:
                assert a.read() == b.read(), r
    got, want = tread.fetchPly(tply), tread.fetchPly(jply)
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.colors, want.colors)
    assert 300 < len(got.points) < 400      # the outliers went


def test_statistical_outlier_filter_matches_jax():
    xyz, rgb = cloud(1)
    xyz = xyz.astype(np.float64)
    for k, s in ((20, 2.0), (5, 1.0)):
        tp, tc = ttri.statistical_outlier_filter(xyz, rgb, k, s)
        jp, jc = jtri.statistical_outlier_filter(xyz, rgb, k, s)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tc, jc)
        assert len(tp) < len(xyz)
