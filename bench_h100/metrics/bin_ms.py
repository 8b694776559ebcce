"""bin_ms: device-busy ms a traced unit (step or frame) inside the
program's `raster.bin` spans (the raw tile-instance stream, `bin_raw`, and
the padded layout, `bin_gaussians`): the union of the device operations
clipped to each span's aligned extent. Reads `bin_ms.train` and
`.serve`."""

from bench_h100 import spans


def read(r):
    return spans.busy_ms(r, "raster.bin")
