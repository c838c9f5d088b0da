"""Device milliseconds per training step in the backward's segment sum
(``segment_reduce`` kernels, by name in the device trace)."""
from yardstick import per_call_ms


def read(ctx):
    return per_call_ms(ctx, lambda cat, name: cat == "kernel" and "segment_reduce" in name)
