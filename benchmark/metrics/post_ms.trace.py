"""post_ms.trace: read by ``benchmark.spans.post_ms``."""

from benchmark.spans import post_ms as read  # noqa: F401
