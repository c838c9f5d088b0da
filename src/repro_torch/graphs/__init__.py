from .csr import CSRGraph, from_edges, block_diagonal, to_torch_csr
from .batching import (
    BucketPolicy,
    GraphBatch,
    TrafficProfile,
    assemble,
    bucket_ell,
    bucketize,
    micro_batches,
    next_pow2,
)
from .datasets import TABLE4, DatasetSpec, load_dataset, all_datasets, sample_graphs
from .partition import (
    Partition,
    PartitionPlan,
    PlanCandidate,
    extract_row_partitions,
    plan_partition,
)
