"""k2_roofline.train: K2's (blend backward) least time for a step's
counted work (`bench_h100.work.k2` on the reference's pairs of the traced
steps' views) over its profiled device time per step, in percent. Nothing
when K2 did not run."""


def read(r):
    s = r.trace.device_s(lambda name: r.kernel_of(name) == "K2")
    if s <= 0:
        return None
    least = r.work.k2(r.pairs, r.work.AUX[r.aux], r.pixels).seconds()
    return 100.0 * least / (s / r.units)
