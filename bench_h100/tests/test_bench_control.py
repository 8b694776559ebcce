"""`correct` on a toy-size cell on the CPU (the program's plain versions):
a sound run passes its limits; the control (the reference in the lower
precision put in the program's place) and each fault the cell can have,
planted in the program underneath a run, fail them. One chip: no exchange
between chips to leave out."""

import pytest

from bench_h100.tests.toy import run_toy


CELLS = ["static-train", "static-serve", "dynamic-train", "dynamic-serve"]
TRAIN = ["static-train", "dynamic-train"]
SERVE = ["static-serve", "dynamic-serve"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run_toy(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_control_is_not_correct(cell, seed):
    out = run_toy(cell, seed=seed, control=True)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_state_unchanged_is_not_correct(cell, monkeypatch):
    from vegs_torch import optim

    monkeypatch.setattr(optim, "adam_step", lambda *a, **k: None)
    out = run_toy(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_batch_is_not_correct(cell, monkeypatch):
    """The loss over the left half of each view's pixels alone."""
    from vegs_torch import train

    full = train.image_loss

    def half(out, gt, normal, normal_valid, opt_cfg):
        w = gt.shape[-1] // 2
        out = out._replace(rgb=out.rgb[..., :w], cov_quat=out.cov_quat[..., :w],
                           cov_scale=out.cov_scale[..., :w])
        return full(out, gt[..., :w], normal[..., :w], normal_valid, opt_cfg)

    monkeypatch.setattr(train, "image_loss", half)
    out = run_toy(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", SERVE)
def test_altered_frame_is_not_correct(cell, monkeypatch):
    """A frame's pixels altered where the entry renders them."""
    from vegs_torch import render_video

    real, real_all = render_video.render, render_video.render_all

    def altered(*a, **k):
        out = real(*a, **k)
        rgb = out.rgb.clone()
        rgb[:, :8, :8] += 0.25
        return out._replace(rgb=rgb)

    monkeypatch.setattr(render_video, "render", altered)
    monkeypatch.setattr(render_video, "render_all",
                        lambda *a, **k: _altered_all(real_all, *a, **k))
    out = run_toy(cell)
    assert not out["correct"], out["checks"]


def _altered_all(real_all, *a, **k):
    out, bounds = real_all(*a, **k)
    rgb = out.rgb.clone()
    rgb[:, :8, :8] += 0.25
    return out._replace(rgb=rgb), bounds
