"""frame_mfu.serve: a rendered frame's least time on the card
(`bench_h100.work.frame`: its counted fp32 operations at 67 TFLOP/s or its
counted bytes at 3.35 TB/s, whichever is longer) over the window's
host-clock time per frame, in percent."""


def read(r):
    if r.kind != "serve":
        return None
    least = r.work.frame(r.n, r.pairs, r.aux, r.pixels).seconds()
    return 100.0 * least / r.window_unit_s
