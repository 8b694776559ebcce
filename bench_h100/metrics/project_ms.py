"""project_ms: device-busy ms a traced unit (step or frame) inside the
program's `raster.project` spans (covariances, SH colours, the payload
tables' build and pad): the union of the device operations clipped to each
span's aligned extent. Reads `project_ms.train` and `.serve`."""

from bench_h100 import spans


def read(r):
    return spans.busy_ms(r, "raster.project")
