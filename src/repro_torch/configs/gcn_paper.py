"""The paper's own workload: 2-layer GCN over the Table-4 datasets.

This is the 11th selectable config — the GNN the dataflow taxonomy was
built for.  It parameterizes repro_torch.gnn rather than the LM substrate.
"""
from ..gnn.model import GNNConfig

# Kipf-standard hidden width; per-dataset f_in/n_classes are bound by the
# dataset loader at run time.
CONFIG = GNNConfig(kind="gcn", hidden=16, n_layers=2, policy="sp_opt", order="AC")
