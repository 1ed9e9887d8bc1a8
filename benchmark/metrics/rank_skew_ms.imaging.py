"""rank_skew_ms.imaging: read by ``benchmark.spans.rank_skew_ms``."""

from benchmark.spans import rank_skew_ms as read  # noqa: F401
