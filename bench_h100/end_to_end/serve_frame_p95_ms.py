"""serve_frame_p95_ms: the 95th percentile (inclusive quantiles) of every
frame's time of the window, from its call to its pixels on the host."""

import statistics


def read(res):
    if res["kind"] != "serve":
        return None
    lat = res["latencies_s"]
    if len(lat) < 2:
        return lat[0] * 1e3
    return statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3
