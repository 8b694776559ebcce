"""update_ms.train: device-busy ms a traced step inside the program's
`train.update` span (Adam, the densify statistics, the box fields' and
residuals' steps): the union of the device operations clipped to its
aligned extent."""

from bench_h100 import spans


def read(r):
    return spans.busy_ms(r, "train.update")
