"""cpi_s.imaging: the window's seconds over its CPIs (each traced, its map
rendered to the host), first CPI's start to last CPI's end."""


def read(record):
    return record.window_s / record.cpis if record.cpis else None
