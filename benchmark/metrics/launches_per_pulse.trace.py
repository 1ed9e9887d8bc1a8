"""launches_per_pulse.trace: read by ``benchmark.readers.launches_per_pulse``."""

from benchmark.readers import launches_per_pulse as read  # noqa: F401
