from .layers import (
    EllAdjacency,
    LAYER_FNS,
    POLICIES,
    aggregate_full,
    gcn_layer,
    gin_layer,
    init_layer,
    multiphase_matmul,
    params_from_numpy,
    sage_layer,
    segment_readout,
)
from .model import (
    GNNConfig,
    forward_layers,
    gnn_forward,
    gnn_loss,
    init_gnn,
    make_node_classification_task,
    masked_xent_loss,
)
