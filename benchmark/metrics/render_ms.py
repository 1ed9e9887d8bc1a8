"""render_ms: read by ``benchmark.readers.render_ms``."""

from benchmark.readers import render_ms as read  # noqa: F401
