"""Device milliseconds per scored batch in copies (the replay's copies of
the features, the adjacency and the parameters into the graph's static
buffers, and of the answer out), from the device trace."""
from yardstick import per_call_ms


def read(ctx):
    return per_call_ms(ctx, lambda cat, name: cat == "gpu_memcpy")
