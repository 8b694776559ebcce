"""host_syncs: the times a traced unit (step or frame) blocks the host on
the device, as the program counts them while the unit runs (`host_sync`:
the synchronizing calls CUDA's sync debug mode warns of). Reads
`host_syncs.train` and `.serve`."""

from bench_h100 import spans


def read(r):
    return spans.host_syncs(r)
