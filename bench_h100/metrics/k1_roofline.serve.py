"""k1_roofline.serve: K1's (blend forward) least time for a frame's
counted work (`bench_h100.work.k1` on the reference's pairs of the traced
frames) over its profiled device time per frame, in percent. Nothing when
K1 did not run."""


def read(r):
    s = r.trace.device_s(lambda name: r.kernel_of(name) == "K1")
    if s <= 0:
        return None
    least = r.work.k1(r.pairs, r.work.AUX[r.aux], r.pixels).seconds()
    return 100.0 * least / (s / r.units)
