"""backward_ms.train: device-busy ms a traced step inside the program's
`train.backward` span (`loss.backward()`: K2, K3 and autograd's glue): the
union of the device operations clipped to its aligned extent."""

from bench_h100 import spans


def read(r):
    return spans.busy_ms(r, "train.backward")
