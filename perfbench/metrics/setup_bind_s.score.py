"""Host seconds of set-up in ``Program.bind`` (``setup.bind_s``, the
program's own counter, read at the end: the window binds nothing): each
batch's padded-ELL build on the host (``CSRGraph.to_ell``) and its upload."""
from program_counters import value


def read(ctx):
    return value("setup.bind_s")
