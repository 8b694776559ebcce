"""Metrics logging and step timing (port of vegs_tpu/utils/logging.py).

`MetricsLogger`: one JSON object a line in `<out_dir>/metrics.jsonl`, in
the JAX package's layout (the record's keys, then `step`). `StepTimer`:
wall-clock seconds per named phase, smoothed by an exponential moving
average. `trace_steps`: a `torch.profiler` trace of the steps inside it,
written for TensorBoard.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


class MetricsLogger:
    """Append-only JSONL metrics, one dict per record."""

    def __init__(self, out_dir):
        self.path = Path(out_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        rec = dict(metrics)
        if step is not None:
            rec["step"] = step
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class StepTimer:
    """Wall-clock seconds per phase, an EMA over calls:

        timer = StepTimer()
        with timer("render"):
            ...
        timer.summary() -> {"render": ema_seconds, ...}

    The first call sets the value, each later one `ema * prev + (1 - ema) *
    dt`. On the card, time only what has synchronized inside the block."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.times: dict[str, float] = {}

    def __call__(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                dt = time.perf_counter() - self.t0
                prev = timer.times.get(name)
                timer.times[name] = (
                    dt if prev is None
                    else timer.ema * prev + (1 - timer.ema) * dt)

        return _Ctx()

    def summary(self) -> dict[str, float]:
        return dict(self.times)


def trace_steps(log_dir: str):
    """A context manager that profiles what runs inside it (the host, and
    the card's kernels when there is one) and writes the trace for
    TensorBoard's profiler plugin into `log_dir`."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir)))
