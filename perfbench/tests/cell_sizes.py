"""Each cell's small sizes for the CPU tests, one file a cell:
``cells/<cell>.json``, named as ``limits/<cell>.json`` is, holds ``tiny``,
the sizes at which a test runs the whole cell, and ``control``, the sizes
at which the control's rounding shows on the CPU in a test's time.  Each is
``{"config": {...}, "traffic": {...}}``, merged into the cell's
configuration and traffic.  A new cell brings its file; no test needs an
edit."""
import json
from pathlib import Path

CELLS = Path(__file__).resolve().parent / "cells"
SIZES = {p.stem: json.loads(p.read_text()) for p in sorted(CELLS.glob("*.json"))}
#: small sizes of each cell that a CPU test run holds
TINY = {cell: s["tiny"] for cell, s in SIZES.items()}
#: sizes at which the control's rounding shows on the CPU in a test's time
CONTROL = {cell: s["control"] for cell, s in SIZES.items()}
