from .csr import CSRGraph, from_edges, block_diagonal
from .batching import (
    BucketPolicy,
    GraphBatch,
    TrafficProfile,
    assemble,
    bucketize,
    next_pow2,
)
from .datasets import TABLE4, DatasetSpec, load_dataset, all_datasets
