"""exchange_ms.imaging: read by ``benchmark.spans.exchange_ms``."""

from benchmark.spans import exchange_ms as read  # noqa: F401
