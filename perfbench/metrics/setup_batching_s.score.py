"""Host seconds of set-up routing the library into buckets and assembling
its batches (``setup.batching_s``, the program's own counter, read at the
end: the window assembles nothing; ``graphs/batching.py::bucketize`` and
``assemble``)."""
from program_counters import value


def read(ctx):
    return value("setup.batching_s")
