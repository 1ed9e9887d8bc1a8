"""phase1_busy_ms.trace: read by ``benchmark.spans.phase1_busy_ms``."""

from benchmark.spans import phase1_busy_ms as read  # noqa: F401
