"""device_ops_per_step.train: device operations (kernels, copies, fills)
the profiler records per traced training step."""


def read(r):
    return len(r.trace.ops) / r.units if r.trace.ops else None
