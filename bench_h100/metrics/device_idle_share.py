"""device_idle_share: 100 times one minus the union of the device
operations' intervals over the traced window's wall time, which holds
whole steps or frames. Reads `device_idle_share.train` and `.serve`."""


def read(r):
    if not r.trace.ops:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.wall_s)
