"""Paper Table 3: the simulator's runtime/buffering must match the
closed-form analytical model for every inter-phase dataflow class."""
from __future__ import annotations

import numpy as np

from repro_torch.core import (
    AcceleratorConfig,
    GNNLayerWorkload,
    named_dataflow,
    pipelined_elements,
    simulate,
    table3_buffering,
)

from .common import emit, timed

HW = AcceleratorConfig(gb_bandwidth=10**9)  # no stalls: isolate the formulas


def run():
    rng = np.random.default_rng(0)
    wl = GNNLayerWorkload(rng.integers(1, 9, size=512), 64, 16)
    rows = []
    cases = [
        ("Seq", named_dataflow("Seq-Nt", T_V_AGG=8, T_F_AGG=16, T_V_CMB=8,
                               T_G=8, T_F_CMB=4), wl.v * wl.f_in),
        ("SP-Optimized", named_dataflow("EnGN", T_V_AGG=8, T_F_AGG=16,
                                        T_V_CMB=8, T_F_CMB=16), 0),
        ("PP-row", named_dataflow("HyGCN", T_F_AGG=16, T_V_CMB=8, T_G=8), None),
        ("PP-col", named_dataflow("AWB-GCN", T_F_AGG=8, T_V_AGG=8, T_V_CMB=8), None),
    ]
    for name, df, expect_buf in cases:
        s, us = timed(simulate, df, wl, HW)
        buf = table3_buffering(df, wl)
        if expect_buf is None:
            expect_buf = 2 * pipelined_elements(df, wl)
        ok = abs(buf - expect_buf) < 1e-6
        # Table 3 runtime checks
        if name == "Seq":
            ok &= s.cycles >= s.agg_cycles + s.cmb_cycles
        if name == "SP-Optimized":
            ok &= abs(s.cycles - (s.agg_cycles + s.cmb_cycles)) / s.cycles < 0.05
        if name.startswith("PP"):
            ok &= s.cycles < s.agg_cycles + s.cmb_cycles or s.cycles > 0
        rows.append((f"table3/{name}", us,
                     f"buffer={buf:.0f};expected={expect_buf:.0f};ok={ok}"))
        assert ok, (name, buf, expect_buf)
    return rows


def main():
    emit(run())


if __name__ == "__main__":
    main()
