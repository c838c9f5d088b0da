"""The flash-attention kernel's share of its roofline in the prefill cell:
the least time its launches need (bytes over 3.35 TB/s or operations over
the bf16 peak of 989 TFLOP/s, the larger) over their time in the device
trace.  One launch a layer; its operations are the 64 x 64 tiles the
kernel computes under the causal mask and the layer's window, QK^T and PV
at 2 x 2 x 64 x 64 x head_dim each; its bytes q, k, v and the output in
bf16, each once."""
import numpy as np

from yardstick import roofline_pct

#: the kernel's tile of queries and keys
TILE = 64
#: the program's launch counter (the tensor-core route's kernel is named
#: ``flash_tc_kernel<head_dim padded>``)
COUNTERS = {"flash_tc_kernel": "repro_torch.kernels.flash_attention.ops:flash_attention"}


def tiles(seq_len: int, window: int) -> int:
    """64 x 64 tiles of a causal prompt in which some (query, key) pair is
    seen: key block at or before the query block's last row, and within
    the window of its first row when there is one."""
    q0 = np.arange(0, seq_len, TILE)[:, None]
    k0 = np.arange(0, seq_len, TILE)[None, :]
    seen = k0 <= np.minimum(q0 + TILE, seq_len) - 1
    if window > 0:
        seen &= np.minimum(k0 + TILE, seq_len) - 1 > q0 - window
    return int(seen.sum())


def work(config: dict, batch: int, seq_len: int) -> list[tuple[float, float]]:
    hq, hkv, d = (config[k] for k in ("num_attention_heads", "num_key_value_heads", "head_dim"))
    out = []
    for layer_type in config["layer_types"]:
        window = config["sliding_window"] if layer_type == "sliding_attention" else 0
        n_ops = 4 * TILE * TILE * d * tiles(seq_len, window) * batch * hq
        n_bytes = 2 * batch * seq_len * d * (2 * hq + 2 * hkv)
        out.append((float(n_bytes), float(n_ops)))
    return out


def read(ctx):
    return roofline_pct(ctx, "flash_tc_kernel", work)
