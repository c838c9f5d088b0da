"""Host seconds of set-up capturing the CUDA graphs (``setup.capture_s``,
the program's own counter, read at the end: the window captures nothing):
each shape's eager warm-up and its capture."""
from program_counters import value


def read(ctx):
    return value("setup.capture_s")
