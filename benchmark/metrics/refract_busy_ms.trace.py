"""refract_busy_ms.trace: device ms a pulse (the union of the events) of
the work launched inside the program's ``rts.refract`` spans; None where
it has none."""

from benchmark.spans import launched_busy_ms


def read(record):
    busy = launched_busy_ms(record, "rts.refract")
    return None if busy is None or not record.pulses else busy / record.pulses
