"""The port's offline metrics (`vegs_torch.metrics`) against vegs_tpu's.

Seeded PNGs under `{model}/test/{method}/{renders,gt}` (two methods, three
views of 40x56); both packages' `evaluate` on two copies of the tree must
write results.json and per_view.json with the same keys, and every SSIM,
PSNR and LPIPS value within 1e-5 relative (float32 filters and sums in
another order). LPIPS runs when its weight files exist: synthesized VGG16
and LPIPS heads are written to a directory both packages are pointed at.
"""

import json
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_weight_converters import synthesize_torchvision_vgg16_state
from vegs_torch import metrics as tmetrics
from vegs_torch.losses import lpips as tlpips
from vegs_tpu import metrics as jmetrics
from vegs_tpu.losses import lpips as jlpips

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def write_model(path, seed=0):
    rng = np.random.default_rng(seed)
    for method, noise in (("ours_7", 0.05), ("ours_30", 0.2)):
        for sub in ("renders", "gt"):
            (path / "test" / method / sub).mkdir(parents=True)
        for i in range(3):
            gt = rng.uniform(0, 1, (40, 56, 3))
            r = np.clip(gt + rng.normal(0, noise, gt.shape), 0, 1)
            for sub, img in (("renders", r), ("gt", gt)):
                Image.fromarray((img * 255).round().astype(np.uint8)).save(
                    path / "test" / method / sub / f"{i:05d}.png")


def assert_same_results(tpath, jpath, keys):
    for name in ("results.json", "per_view.json"):
        got = json.loads((tpath / name).read_text())
        want = json.loads((jpath / name).read_text())
        assert set(got) == set(want) == {"ours_7", "ours_30"}
        for method in got:
            assert set(got[method]) == set(want[method])
            for k in keys:
                a, b = got[method][k], want[method][k]
                if isinstance(a, dict):
                    assert set(a) == set(b) and len(a) == 3
                    a, b = [a[v] for v in sorted(a)], [b[v] for v in sorted(b)]
                np.testing.assert_allclose(a, b, rtol=RTOL)


def test_evaluate_matches_jax(tmp_path, monkeypatch):
    empty = tmp_path / "no_weights"
    empty.mkdir()
    for mod in (tlpips, jlpips):   # no weights on disk: no LPIPS
        monkeypatch.setattr(mod, "DEFAULT_WEIGHT_DIR", str(empty))
    write_model(tmp_path / "port")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    jmetrics.evaluate([str(tmp_path / "jax")])
    out = tmetrics.evaluate([str(tmp_path / "port")], device="cpu")
    assert_same_results(tmp_path / "port", tmp_path / "jax", ("SSIM", "PSNR"))
    res = json.loads((tmp_path / "port" / "results.json").read_text())
    assert out[str(tmp_path / "port")] == res
    assert "LPIPS" not in res["ours_7"]
    assert res["ours_7"]["PSNR"] > res["ours_30"]["PSNR"]


def test_evaluate_with_lpips_matches_jax(tmp_path, monkeypatch):
    wdir = tmp_path / "weights"
    wdir.mkdir()
    np.savez(wdir / "vgg16_features.npz",
             **synthesize_torchvision_vgg16_state(np.random.default_rng(1)))
    rng = np.random.default_rng(2)
    np.savez(wdir / "lpips_vgg_lins.npz",
             **{f"lin{i}": rng.uniform(size=(1, c, 1, 1)).astype(np.float32)
                for i, c in enumerate(tlpips.LPIPS_CHANNELS)})
    for mod in (tlpips, jlpips):
        monkeypatch.setattr(mod, "DEFAULT_WEIGHT_DIR", str(wdir))
    write_model(tmp_path / "port", seed=3)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    jmetrics.evaluate([str(tmp_path / "jax")])
    tmetrics.evaluate([str(tmp_path / "port")], device="cpu")
    assert_same_results(tmp_path / "port", tmp_path / "jax",
                        ("SSIM", "PSNR", "LPIPS"))
    res = json.loads((tmp_path / "port" / "results.json").read_text())
    assert res["ours_7"]["LPIPS"] > 0


def test_evaluate_dirs_and_cli(tmp_path, monkeypatch, capsys):
    empty = tmp_path / "no_weights"
    empty.mkdir()
    monkeypatch.setattr(tlpips, "DEFAULT_WEIGHT_DIR", str(empty))
    write_model(tmp_path / "m", seed=4)
    d = tmp_path / "m" / "test" / "ours_7"
    got = tmetrics.evaluate_dirs(d / "renders", d / "renders", device="cpu")
    assert got["means"]["SSIM"] > 0.999 and got["means"]["PSNR"] > 100
    assert len(got["per_view"]["PSNR"]) == 3 and not got["per_view"]["LPIPS"]
    monkeypatch.setattr(tmetrics, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    tmetrics.main(["-m", str(tmp_path / "m")])
    printed = json.loads(capsys.readouterr().out)
    assert set(printed[str(tmp_path / "m")]) == {"ours_7", "ours_30"}
