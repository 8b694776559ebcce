"""box_compose_ms: device-busy ms a traced unit (step or frame) inside the
program's `boxes.compose` spans (each vehicle's field moved to the world by
its box, residual folded in): the union of the device operations clipped
to each span's aligned extent. None where no traced unit composed a box
(the counter `boxes.instances`). Reads `box_compose_ms.serve` (and a
`.train` the same way)."""

from bench_h100 import spans


def read(r):
    if not spans.counts(r).get("boxes.instances"):
        return None
    return spans.busy_ms(r, "boxes.compose")
