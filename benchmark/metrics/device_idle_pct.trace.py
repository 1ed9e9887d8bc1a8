"""device_idle_pct.trace: read by ``benchmark.readers.device_idle_pct``."""

from benchmark.readers import device_idle_pct as read  # noqa: F401
