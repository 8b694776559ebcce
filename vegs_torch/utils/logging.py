"""Metrics logging (port of vegs_tpu/utils/logging.py).

`MetricsLogger`: one JSON object a line in `<out_dir>/metrics.jsonl`, in
the JAX package's layout (the record's keys, then `step`). Spans, counters
and the operator's trace (`trace_steps`) are `vegs_torch.utils.trace`'s.
"""

from __future__ import annotations

import json
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
