"""mt_traverse_roofline: read by ``benchmark.readers.kernel_roofline_pct``."""

from benchmark.readers import kernel_roofline_pct as read  # noqa: F401
