"""gather_ms: device-busy ms a traced unit (step or frame) inside the
program's `raster.gather` spans (the payload rows' gather to the padded
slots): the union of the device operations clipped to each span's aligned
extent. Reads `gather_ms.train` and `.serve`."""

from bench_h100 import spans


def read(r):
    return spans.busy_ms(r, "raster.gather")
