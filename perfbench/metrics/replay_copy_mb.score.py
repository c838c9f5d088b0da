"""Megabytes a CUDA-graph replay copies into the graph's static buffers
(``replay.bytes_in`` over ``replay.calls``, the program's own counters,
over the run): the batch's features, its adjacency, its segment ids and
the parameters."""
from program_counters import ratio


def read(ctx):
    return ratio("replay.bytes_in", "replay.calls", 1e-6)
