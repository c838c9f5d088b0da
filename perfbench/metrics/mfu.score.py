"""Model FLOPs of the graphs scored in the timed window (per layer 2 V F G
+ 2 nnz min(F, G), real graphs only) over the window's seconds and 67
TFLOP/s, in percent."""
from yardstick import mfu_pct as read  # noqa: F401
