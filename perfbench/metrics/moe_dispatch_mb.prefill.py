"""Megabytes an MoE layer's dispatch writes (``moe.dispatch_bytes`` over
``moe.calls``, the program's own counters, over the run): the expert
sort's gathered rows and the weighted un-sort, top-k rows a token each."""
from program_counters import ratio


def read(ctx):
    return ratio("moe.dispatch_bytes", "moe.calls", 1e-6)
