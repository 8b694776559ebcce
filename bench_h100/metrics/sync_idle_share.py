"""sync_idle_share: the percent of the traced units' idle device time
inside the extents of the program's sync spans, from the drain the host
waits for to its wake (`bench_h100.spans.sync_idle_share`); the rest the
host spends launching or computing. Reads `sync_idle_share.train` and
`.serve`."""

from bench_h100 import spans


def read(r):
    return spans.sync_idle_share(r)
