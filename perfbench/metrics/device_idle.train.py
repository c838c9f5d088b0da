"""Share of the timed training window in which nothing ran on the card:
the device seconds a step takes in the traced slice, times the window's
steps, against the window's seconds (every step does the same work)."""
from yardstick import window_idle_pct as read  # noqa: F401
