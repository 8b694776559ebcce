"""ops_device_ms: the device milliseconds per traced unit (step or frame)
in every device operation that is not one of the hand-written kernels
K1-K4: projection, binning, gathers, losses, Adam, densify, copies. Reads
`ops_device_ms.train` and `.serve`."""


def read(r):
    ms = r.trace.device_s(lambda name: r.kernel_of(name) is None) * 1e3
    return ms / r.units if r.trace.ops else None
