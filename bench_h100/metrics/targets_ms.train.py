"""targets_ms.train: device-busy ms a traced step inside the program's
`train.targets` span (the ground truth's, the normal map's and the
camera's copies to the device): the union of the device operations
clipped to its aligned extent."""

from bench_h100 import spans


def read(r):
    return spans.busy_ms(r, "train.targets")
