"""prepare_s: read by ``benchmark.readers.prepare_s``."""

from benchmark.readers import prepare_s as read  # noqa: F401
