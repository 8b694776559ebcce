"""General helpers (port of vegs_tpu/utils/general.py): seeding with a
timestamping stdout. The JAX module's `inverse_sigmoid` is
`vegs_torch.gaussians.inverse_sigmoid` here; its `check_objects_in_frame`
has no caller and is not ported."""

from __future__ import annotations

import random
import sys
from datetime import datetime

import numpy as np
import torch


class TimestampedStdout:
    """A stdout that appends ` [dd/mm HH:MM:SS]` to every line it writes
    (nothing with `silent`); `wrapped` is the stream it writes to."""

    def __init__(self, wrapped, silent: bool = False):
        self.wrapped = wrapped
        self.silent = silent

    def write(self, x):
        if self.silent:
            return
        if x.endswith("\n"):
            ts = datetime.now().strftime("%d/%m %H:%M:%S")
            x = x.replace("\n", f" [{ts}]\n")
        self.wrapped.write(x)

    def flush(self):
        self.wrapped.flush()


def safe_state(silent: bool = False, seed: int = 0):
    """Seed `random`, numpy and torch (every device) with `seed` and
    replace `sys.stdout` with a `TimestampedStdout` around it, as the JAX
    package does. A caller that prints machine-read lines afterwards must
    put the old stdout back (`sys.stdout = sys.stdout.wrapped`)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    sys.stdout = TimestampedStdout(sys.stdout, silent)

