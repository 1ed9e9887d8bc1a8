"""host_ops_per_pulse.trace: read by ``benchmark.readers.host_ops_per_pulse``."""

from benchmark.readers import host_ops_per_pulse as read  # noqa: F401
