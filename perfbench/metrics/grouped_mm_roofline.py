"""The MoE's grouped expert product's share of its roofline in the prefill
cell: the least time its launches need (bytes over 3.35 TB/s or
operations over the bf16 peak of 989 TFLOP/s, the larger) over their time
in the device trace.  Three launches a layer (gate, up, down), each over
the top-k rows of every token, 2 x rows x hidden x expert width FLOPs; its
bytes every held expert's weights, the rows read and the rows written, in
bf16, each once."""
from yardstick import roofline_pct

#: the program's launch counter of ``torch._grouped_mm``, keyed by the
#: name of the CUTLASS grouped GEMM kernel it launches on the card
KERNEL = "GroupProblemShape"
COUNTERS = {KERNEL: "repro_torch.models.moe:grouped_mm"}


def work(config: dict, batch: int, seq_len: int) -> list[tuple[float, float]]:
    d, f, e = config["hidden_size"], config["moe_intermediate_size"], config["num_experts"]
    rows = batch * seq_len * config["num_experts_per_tok"]
    weights = 2 * e * d * f
    launch = (float(weights + 2 * rows * (d + f)), float(2 * rows * d * f))
    return [launch] * (3 * config["num_hidden_layers"])


def read(ctx):
    return roofline_pct(ctx, KERNEL, work)
