"""Timing on the card, and the card's name and power limit.

`cuda_ms` times a callable with CUDA events over many launches after
warm-ups: the time the stream takes, host gaps between launches included.
`device_profile` reads the card's own time for the same calls from
torch.profiler: the summed durations of the kernels, copies and sets they
launch, without the host's gaps. The two differ where the host, not the
card, sets the pace -- for a kernel of a few tens of microseconds behind a
Python wrapper, or a stage that launches hundreds of small kernels. They
take the place of the JAX tools' in-jit `fori_loop` differencing
(perf/micro3_r02.py:33-48, perf/r09_refscale.py:41-56), which worked around
a remote TPU's dispatch latency. Where the profiler records no device
operation at all (on an H100, late in a long process, it has come back
empty window after window), or records only part of a window (on an
H100, one of ten launches of a one-kernel call), `queued_ms` reads the
card's time from CUDA events instead, with the stream held busy while the
host queues the calls.
"""

from __future__ import annotations

import subprocess
import time

import torch

PROFILE_TRIES = 3
PROFILE_ITERS = 10  # calls in each profiling window
QUEUE_TRIES = 3  # sleeps, each twice as long as the last, in `queued_ms`
# the two times come from different windows of calls, so allow some noise
DEVICE_OVER_STREAM = 1.25


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of `fn` between two CUDA events recorded around
    `iters` calls, after `warmup` calls and a synchronize. Host gaps
    between the calls count: the events time the stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def device_profile(fn, iters: int = PROFILE_ITERS, top: int = 3) -> dict:
    """The card's time per call of `fn` under torch.profiler: "device_ms",
    the summed durations of its device operations (kernels, copies, sets;
    one stream, so they do not overlap); "device_ops", their number per
    call; "top", the `top` operations by device ms per call;
    "device_source", "profiler".

    The profiler runs two windows of `iters` calls and reads the second:
    the first warms it up (in a window opened cold, an H100 run missed 3 of
    20 launches of a one-kernel call). Every call on the same inputs
    launches the same operations, so a window whose count of device
    operations is not a positive multiple of `iters` has lost some (late
    in a long process an H100 run recorded 1 of 10 launches, or 16,733
    operations in a window of 10 calls). Such a window is taken again, up to
    `PROFILE_TRIES` in all; after that the
    time is `queued_ms`'s, "device_ops" None, "top" empty and
    "device_source" "queued_events"; or, where `fn` waits on the card and
    the host sets the pace, `cuda_ms`'s stream time, "stream_events"."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        by_name, count = {}, 0
        for e in prof.events():
            # the step marks are ranges on the device's timeline that span
            # the window's operations, not operations of their own
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or e.name.startswith("ProfilerStep")
                    or getattr(e, "is_user_annotation", False)):
                continue
            us = e.time_range.end - e.time_range.start
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + us
            count += 1
        if count and count % iters == 0:
            break
    else:
        try:
            ms, source = queued_ms(fn, iters), "queued_events"
        except HostPaced:
            ms, source = cuda_ms(fn, iters), "stream_events"
        return {"device_ms": ms, "device_ops": None, "top": {},
                "device_source": source}
    lead = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ms": sum(by_name.values()) / 1e3 / iters,
            "device_ops": count / iters,
            "top": {k: v / 1e3 / iters for k, v in lead},
            "device_source": "profiler"}


class HostPaced(RuntimeError):
    """`queued_ms` could not keep the stream busy: the calls wait on the
    card."""


def queued_ms(fn, iters: int = PROFILE_ITERS, warmup: int = 3) -> float:
    """The card's ms per call of `fn` without the host's gaps, from CUDA
    events alone: a sleep kernel (`torch.cuda._sleep`) holds the stream
    while the host queues the start event, `iters` calls and the end
    event, so the calls run back to back. The sleep must outlast the
    host's queueing, measured from just before the sleep is queued; a
    sleep that did not is taken again, twice as long, up to `QUEUE_TRIES`
    in all. Raises `HostPaced` if none did: then `fn` waits on the card
    itself (a host read, a synchronize) and the host sets the pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    a, s, e = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    a.record()
    torch.cuda._sleep(10 ** 7)
    s.record()
    s.synchronize()
    cycles_per_ms = 10 ** 7 / a.elapsed_time(s)
    sleep_ms = 2 * host_ms + 1.0
    for _ in range(QUEUE_TRIES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        queued = (time.perf_counter() - t0) * 1e3
        e.synchronize()
        if a.elapsed_time(s) > queued:
            return s.elapsed_time(e) / iters
        sleep_ms *= 2
    raise HostPaced(f"the host queued {iters} calls more slowly than a "
                       f"{sleep_ms / 2:.3f} ms sleep ran: the calls wait on "
                       f"the card")


def measure(fn, device: torch.device, iters: int = 20,
            warmup: int = 3) -> dict:
    """On a CUDA device: {"ms": stream time by CUDA events (`cuda_ms`),
    **`device_profile`} (windows of at most PROFILE_ITERS of the `iters`
    calls); raises if the card's own time exceeds the stream's by more than
    `DEVICE_OVER_STREAM` (the profiler then counted something twice). On
    the CPU: {"cpu_ms": host time}, which is never a device number."""
    if device.type == "cuda":
        t = {"ms": cuda_ms(fn, iters, warmup),
             **device_profile(fn, min(iters, PROFILE_ITERS))}
        if t["device_ms"] > DEVICE_OVER_STREAM * t["ms"]:
            raise RuntimeError(f"device time over stream time: {t}")
        return t
    if device.type != "cpu":
        raise ValueError(f"no timer for device {device}")
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return {"cpu_ms": (time.perf_counter() - t0) / iters * 1e3}


def card_line() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def device_line(device: torch.device) -> str:
    """`card_line()` on a CUDA device, "cpu" on the CPU."""
    return card_line() if device.type == "cuda" else "cpu"
