"""Assignment §Roofline: aggregate the port's dry-run JSONs
(``experiments/dryrun_torch/``) into the per-cell roofline table
(compute/memory/collective terms, dominant bottleneck).

The port's dry-run traces with ``make_fx`` and compiles nothing
(``compile_s`` is 0 by design), so the time column is the trace's seconds
(``lower_s``).  A cell whose time loops are scaled has no temporary memory
(``temp_bytes`` null); the table reads only the roofline block.

    PYTHONPATH=src python -m repro_torch.bench.roofline
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.launch.roofline import format_table

from .common import emit

DRYRUN = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def load_results():
    out = []
    for p in sorted(DRYRUN.glob("*.json")):
        out.append(json.loads(p.read_text()))
    return out


def run():
    results = load_results()
    rows = []
    for r in results:
        if r.get("skipped"):
            continue
        rf = r["roofline"]
        rows.append((
            f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}",
            r.get("lower_s", 0) * 1e6,
            f"bound={rf['dominant_term']};RF={rf['roofline_fraction']:.3f}",
        ))
    return rows


def main():
    results = load_results()
    print(format_table(results))
    emit(run())


if __name__ == "__main__":
    main()
