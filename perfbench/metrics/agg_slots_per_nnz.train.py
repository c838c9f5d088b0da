"""Padded-ELL slots the eager tier walks (``agg.slots``: each band of
``gnn/layers.py::aggregate_band`` and each product of its backward that
walks the slots, B x D a band, pad slots included) over the non-zero slots
of the adjacency each ``Program.run`` / ``train_step`` call was given
(``ell.nonzero``), over the run; the program's own counters.  Where every
walk of a call runs the padded ELL whole, it is the walks a call times
V_pad x D over the non-zero slots."""
from program_counters import agg_slots_per_nnz as read  # noqa: F401
