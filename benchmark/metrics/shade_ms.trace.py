"""shade_ms.trace: read by ``benchmark.spans.shade_ms``."""

from benchmark.spans import shade_ms as read  # noqa: F401
