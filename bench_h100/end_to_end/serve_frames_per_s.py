"""serve_frames_per_s: every frame delivered to the host in the window,
over the window's whole time."""


def read(res):
    if res["kind"] != "serve":
        return None
    return len(res["latencies_s"]) / res["elapsed_s"]
