"""Share of the timed prefill window in which nothing ran on the card: the
device seconds a prefill takes in the traced slice, times the window's
prefills, against the window's seconds (every prefill does the same
work)."""
from yardstick import window_idle_pct as read  # noqa: F401
