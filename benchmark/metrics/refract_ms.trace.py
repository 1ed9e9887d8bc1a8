"""refract_ms.trace: the host ms a pulse of the program's ``rts.refract``
spans (the refraction spawn in shading); None where it has none."""

from benchmark.spans import span_ms


def read(record):
    return span_ms(record, "rts.refract")
