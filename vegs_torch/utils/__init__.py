"""Host-side utilities (port of vegs_tpu/utils, subset)."""

from .general import safe_state  # noqa: F401
from .logging import MetricsLogger  # noqa: F401
