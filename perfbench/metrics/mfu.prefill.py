"""Model FLOPs of the timed window's prefills (the reference's count: every
projection, the attended pairs, the top-k experts and the head at every
position) over its seconds and the bf16 peak of 989 TFLOP/s, in percent."""
from yardstick import mfu_pct as read  # noqa: F401
