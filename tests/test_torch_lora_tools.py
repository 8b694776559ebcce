"""The port's LoRA tools (`vegs_torch.tools.lora_preprocess`,
`vegs_torch.tools.lora_train`) against vegs_tpu's.

`preprocess_segment` with the same seed writes the same crops as JAX's
(PNG bytes decoded equal to the bit) and the same metadata.jsonl (text
equal). The segment-list parser and the crop loader give JAX's results
exactly. `train_segment` on the tiny stack writes a `lora_weights.pkl`
that loads into a fresh port UNet and into the JAX UNet's tree with the
trained leaves, equal to the bit. `main`, with the SD checkpoint loader
replaced by the tiny stack, trains each segment from the fresh leaves and
writes both directory layouts.
"""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_diffusion import tiny_pair
from tests.test_torch_loaders import SEQ, START, toy_kitti360_root
from vegs_torch.diffusion import lora as tlora
from vegs_torch.diffusion import weights as tweights
from vegs_torch.diffusion.pipeline import DiffusionModels as TModels
from vegs_torch.tools import lora_preprocess as tpre, lora_train as ttrain
from vegs_tpu.diffusion import lora as jlora
from vegs_tpu.tools import lora_preprocess as jpre, lora_train as jtrain


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy_kitti360_root(tmp_path_factory.mktemp("k360") / "root")


def test_preprocess_matches_jax(root, tmp_path):
    for name, mod in (("jax", jpre), ("port", tpre)):
        mod.preprocess_segment(root, SEQ, START, START + 4, tmp_path / name,
                               n_images=6, size=24, seed=3)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 7
    for n in names:
        if n.endswith(".png"):
            a = np.asarray(Image.open(tmp_path / "port" / n))
            b = np.asarray(Image.open(tmp_path / "jax" / n))
            assert a.shape == (24, 24, 3)
            np.testing.assert_array_equal(a, b)
    meta = (tmp_path / "port" / "metadata.jsonl").read_text()
    assert meta == (tmp_path / "jax" / "metadata.jsonl").read_text()
    assert json.loads(meta.splitlines()[0])["text"] == tpre.DEFAULT_CAPTION


def test_segments_file_and_loader_match_jax(root, tmp_path):
    seg = tmp_path / "segs.txt"
    seg.write_text("lora/data/kitti360/2013_05_28_drive_0009_sync/"
                   "0000003972_0000004258.tar\n\n"
                   "x/seqB/12_340.tar.gz\n")
    assert ttrain.parse_segments_file(str(seg)) == \
        jtrain.parse_segments_file(str(seg)) == [
            ("2013_05_28_drive_0009_sync", "0000003972", "0000004258"),
            ("seqB", "0000000012", "0000000340")]
    data = tmp_path / "crops"
    tpre.preprocess_segment(root, SEQ, START, START + 4, data, n_images=3,
                            size=24, seed=1)
    for size in (24, 16):
        got = ttrain.load_segment_images(str(data), size=size)
        np.testing.assert_array_equal(
            got, jtrain.load_segment_images(str(data), size=size))
        assert got.shape == (3, 3, size, size) and got.dtype == np.float32
    with pytest.raises(FileNotFoundError):
        ttrain.load_segment_images(str(tmp_path / "segs_missing"))


def test_train_segment_file_loads_in_both_packages(tmp_path):
    jm, tm = tiny_pair(seed=4, lora_rank=2)
    images = np.random.default_rng(0).uniform(0, 1, (3, 3, 32, 32)).astype(
        np.float32)
    before = {n: p.detach().clone() for n, p in tm.unet.named_parameters()
              if tlora.is_lora_path(n)}
    seen = []
    losses = ttrain.train_segment(tm, images, str(tmp_path / "out"), steps=2,
                                  seed=0, grad_accum=2,
                                  on_step=lambda i, l: seen.append((i, l)))
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert [i for i, _ in seen] == [0, 1]
    trained = {n: p.detach().clone() for n, p in tm.unet.named_parameters()
               if tlora.is_lora_path(n)}
    assert any(not torch.equal(before[n], trained[n]) for n in trained)
    # into a fresh port UNet
    g = torch.Generator().manual_seed(9)
    fresh = TModels.tiny(g, lora_rank=2).unet
    tlora.load_lora_weights(fresh, tmp_path / "out")
    for n, p in fresh.named_parameters():
        if n in trained:
            assert torch.equal(p, trained[n]), n
    # into the JAX UNet's tree
    params = jlora.load_lora_weights(jm.unet_params, str(tmp_path / "out"))
    flat = jlora.split_lora(params)
    assert set(flat) == {tlora.flax_lora_key(n) for n in trained}
    for n, p in trained.items():
        np.testing.assert_array_equal(flat[tlora.flax_lora_key(n)],
                                      p.numpy().T)
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(jm.unet_params)


def test_main_trains_each_segment_from_fresh_leaves(root, tmp_path,
                                                    monkeypatch):
    g = torch.Generator().manual_seed(2)
    models = TModels.tiny(g, lora_rank=2)
    fresh = {n: p.detach().clone() for n, p in models.unet.named_parameters()
             if tlora.is_lora_path(n)}
    starts = []

    def load(checkpoint_dir, prompt, lora_dir=None, **kw):
        assert (checkpoint_dir, lora_dir) == ("sd", "init")
        return models

    orig = tlora.train_lora

    def train(m, images, **kw):
        starts.append({n: p.detach().clone()
                       for n, p in m.unet.named_parameters() if n in fresh})
        return orig(m, images, **kw)

    monkeypatch.setattr(tweights, "load_sd_checkpoint", load)
    monkeypatch.setattr(tlora, "train_lora", train)
    # the crops at 32 (main loads them at 512; the tiny UNet's attention
    # over a 256x256 latent would take tens of GB)
    load_images = ttrain.load_segment_images
    monkeypatch.setattr(ttrain, "load_segment_images",
                        lambda d, size=512: load_images(d, size=32))
    segs = tmp_path / "segs.txt"
    lines = []
    for a, b in ((START, START + 2), (START + 2, START + 4)):
        tpre.preprocess_segment(
            root, SEQ, a, b,
            tmp_path / "data" / SEQ / f"{a:010d}_{b:010d}", n_images=2,
            size=32, seed=a)
        lines.append(f"lora/data/{SEQ}/{a:010d}_{b:010d}.tar")
    segs.write_text("\n".join(lines) + "\n")
    ttrain.main(["--checkpoint_dir", "sd", "--data_root",
                 str(tmp_path / "data"), "--out_dir", str(tmp_path / "models"),
                 "--segments_file", str(segs), "--steps", "1",
                 "--grad_accum", "1"])
    assert len(starts) == 2
    for s in starts:
        for n, p in s.items():
            assert torch.equal(p, fresh[n]), n
    for a, b in ((START, START + 2), (START + 2, START + 4)):
        for d in (f"{a:010d}_{b:010d}", f"{a}_{b}"):
            assert (tmp_path / "models" / SEQ / d / "lora_weights.pkl").exists()
