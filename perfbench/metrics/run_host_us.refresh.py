"""Host microseconds of one ``Program.run`` call, the median over a burst
of calls dispatched from an idle card after the timed window (the
benchmark's own span around each call), so that the launch queue has room
and the span holds the front end's host path, not a wait for the card."""
import statistics


def read(ctx):
    runs = [(b - a) / 1e3 for name, a, b in ctx.burst if name == "run"]
    return statistics.median(runs) if runs else None
