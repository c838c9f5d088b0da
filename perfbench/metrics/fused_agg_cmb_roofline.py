"""The fused aggregation-combination kernel's share of its roofline: the
least time its launches need (bytes over 3.35 TB/s or operations over 67
TFLOP/s, the larger, counted from each batch's adjacency and the layer
widths) over their time in the device trace."""
from yardstick import fused_agg_cmb_work, roofline_pct

#: the program's launch counter of the kernel (a replay adds its capture's)
COUNTERS = {"fused_agg_cmb": "repro_torch.kernels.fused_agg_cmb.ops:fused_agg_cmb"}


def read(ctx):
    return roofline_pct(ctx, "fused_agg_cmb", fused_agg_cmb_work)
