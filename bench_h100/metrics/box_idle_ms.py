"""box_idle_ms: device-idle ms a traced unit (step or frame) inside the
union of the program's box spans (`boxes.compose`, `boxes.update`,
`boxes.copy`): what the host's dispatch of the vehicles one by one and
their copies cost the card. None where no traced unit composed a box (the
counter `boxes.instances`) or the alignment fails (`spans.units`). Reads
`box_idle_ms.serve` (and a `.train` the same way)."""

from bench_h100 import spans
from bench_h100.profile import union

BOX_SPANS = ("boxes.compose", "boxes.update", "boxes.copy")


def read(r):
    if not spans.counts(r).get("boxes.instances"):
        return None
    us = spans.units(r)
    if us is None:
        return None
    busy = spans.Busy(r.trace.ops)
    idle = 0.0
    for u in us:
        for a, b in union([(None, s.start_us, s.end_us) for s in u.spans
                           if s.name in BOX_SPANS]):
            idle += (b - a) - busy.within(a, b)
    return idle / 1e3 / len(us)
