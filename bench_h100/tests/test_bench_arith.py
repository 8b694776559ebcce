"""The harness's arithmetic: rates and the 95th percentile over a window,
the device's busy union and idle gaps, the least work against
vegs_torch/perf/roofline.py's at two shapes."""

import math
import statistics

import pytest

from bench_h100 import profile, run, work


def test_rate_and_p95():
    lat = [0.01 * (i + 1) for i in range(100)]   # 10 ms .. 1000 ms
    res = {"kind": "serve", "setup_s": 3.0, "window_peak": 2 ** 31,
           "latencies_s": lat, "elapsed_s": 50.5}
    e = run.end_to_end(res, ["serve_frames_per_s", "serve_frame_p95_ms",
                             "peak_mem_gib", "setup_s", "train_steps_per_s"])
    assert e["train_steps_per_s"] is None and e["setup_s"] == 3.0
    assert e["serve_frames_per_s"] == pytest.approx(100 / 50.5)
    # inclusive quantiles: position 0.95 * 99 = 94.05 -> 950 + 0.05 * 10 ms
    assert e["serve_frame_p95_ms"] == pytest.approx(950.5)
    assert e["peak_mem_gib"] == 2.0
    t = run.end_to_end({"kind": "train", "setup_s": 1.0, "window_peak": 0,
                        "attempted": 120, "elapsed_s": 10.0},
                       ["train_steps_per_s", "serve_frames_per_s"])
    assert t["serve_frames_per_s"] is None
    assert t["train_steps_per_s"] == 12.0


def test_busy_union_and_idle():
    ops = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 32, 35),
           ("blend_fwd_kernel", 50, 60)]
    host = [(0, 100, "step"), (19, 31, "aten::sort"), (39, 52, "aten::mul")]
    tr = profile.Trace(wall_s=100e-6, ops=ops, host=sorted(host))
    assert profile.union(ops) == [[0, 20], [30, 40], [50, 60]]
    assert tr.busy_s() == pytest.approx(40e-6)
    assert tr.device_s(lambda n: profile.kernel_of(n) == "K1") == pytest.approx(10e-6)
    gaps = dict(profile.idle_gaps(tr))
    assert gaps == {"aten::sort": pytest.approx(10e-6),
                    "aten::mul": pytest.approx(10e-6)}
    assert profile.kernel_of("void blend_bwd_kernel<8>") == "K2"
    assert profile.kernel_of("vectorized_gather_kernel") is None


@pytest.mark.parametrize("shape", [
    dict(n=2_233_571, tested=25_648_301, included=25_293_078, slots=1_871_834,
         h=376, w=1408),
    dict(n=500_000, tested=6_000_000, included=5_500_000, slots=700_000,
         h=128, w=512)])
def test_work_against_roofline(shape):
    """The blend's counts are roofline.py's with the walk counted only over
    tested pairs, without the tile ranges' bytes and over the image's
    pixels rather than the padded tile grid's."""
    from vegs_torch.perf import roofline

    pairs = {k: shape[k] for k in ("tested", "included", "slots")}
    rpairs = dict(pairs, walked=shape["tested"])
    h, w = shape["h"], shape["w"]
    hp, wp = -(-h // 16) * 16, -(-(-(-w // 16)) // 8) * 8 * 16
    tiles = hp // 16 * wp // 16
    for ab in (2, 4):
        r1 = roofline.k1_work(rpairs, ab, tiles, hp, wp)
        m1 = work.k1(pairs, ab, h * w)
        assert m1.ops == r1.ops
        assert m1.bytes == r1.bytes - 4 * (tiles + 1) - 48 * (hp * wp - h * w)
        r2 = roofline.k2_work(rpairs, ab, shape["slots"], tiles, hp, wp)
        m2 = work.k2(pairs, ab, h * w)
        assert m2.ops == r2.ops
        assert m2.bytes == r2.bytes - 4 * (tiles + 1) - 96 * (hp * wp - h * w)
    assert roofline.PEAK_BYTES_PER_S == work.PEAK_BYTES_PER_S
    assert roofline.PEAK_F32_PER_S == work.PEAK_F32_PER_S
    n = shape["n"]
    # the step's least time is at least Adam's traffic over the bandwidth
    adam = n * work.PARAM_BYTES * 7 / work.PEAK_BYTES_PER_S
    assert work.step(n, pairs, "bf16", h * w).seconds() > adam
    assert work.frame(n, pairs, "bf16", h * w).seconds() < adam
    assert math.isfinite(statistics.fmean([adam]))
