"""Share of a traced slice of the scoring window in which nothing ran on
the card (device trace)."""
from yardstick import idle_pct as read  # noqa: F401
