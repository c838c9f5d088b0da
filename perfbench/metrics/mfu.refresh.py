"""Model FLOPs of the full-graph forwards of the timed window over its
seconds and 67 TFLOP/s, in percent."""
from yardstick import mfu_pct as read  # noqa: F401
