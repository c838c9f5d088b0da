from .taxonomy import (
    Binding,
    GNNDataflow,
    Granularity,
    InterPhase,
    IntraPhaseDataflow,
    Loop,
    PhaseOrder,
    enumerate_dataflows,
    intra,
    named_dataflow,
)
from .hw import AcceleratorConfig, HWGrid, DEFAULT_ACCEL
from .registry import (
    Objective,
    get_objective,
    kernel_policies,
    lookup_kernel,
    objective_names,
    objective_value,
    register_kernel,
    register_objective,
    unregister_objective,
)
from .cost_model import (
    BandStats,
    GNNLayerWorkload,
    PhaseCost,
    TileStats,
    aggregation_cost,
    combination_cost,
    pipelined_elements,
    table3_buffering,
)
from .schedule import (
    ExecSpec,
    LayerSchedule,
    ModelSchedule,
    TransitionSpec,
    default_dataflow,
    policy_of,
    transition_spec,
)
from .simulator import (
    BatchStats,
    ModelStats,
    RunStats,
    TransitionStats,
    simulate,
    simulate_batch,
    simulate_model,
    transition_cost,
    validate_workload_chain,
)
from .mapper import (
    CodesignPoint,
    CodesignResult,
    FlexibilityReport,
    MappingResult,
    TABLE5_NAMES,
    flexibility_value,
    optimize_tiles,
    optimize_tiles_topk,
    search_codesign,
    search_dataflows,
    search_model,
    search_model_codesign,
    sweep_pe_splits,
)
from .taxonomy import DataflowSkeleton, SkeletonPhase, Cons, named_skeleton, SKELETONS
from .taxonomy import input_walk, output_walk, parse_dataflow
