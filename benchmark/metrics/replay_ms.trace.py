"""replay_ms.trace: read by ``benchmark.spans.replay_ms``."""

from benchmark.spans import replay_ms as read  # noqa: F401
