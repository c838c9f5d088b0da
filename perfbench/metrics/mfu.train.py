"""Three times the forward's model FLOPs per training step, over the
window's seconds per step and 67 TFLOP/s, in percent."""
from yardstick import mfu_pct as read  # noqa: F401
