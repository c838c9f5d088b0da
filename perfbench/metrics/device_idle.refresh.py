"""Share of the timed refresh window in which nothing ran on the card: the
device seconds a forward takes in the traced slice, times the window's
forwards, against the window's seconds (every forward does the same
work; the profiler's host cost would starve the card in the slice)."""
from yardstick import window_idle_pct as read  # noqa: F401
