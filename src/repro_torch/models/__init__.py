"""The LM substrate (the port of :mod:`repro.models`): every block kind
(``attn``, ``local``, ``moe``, ``rglru``, ``mlstm``, ``slstm``), with the
flash-attention kernel on the prefill path and ``lm_loss`` (plain
versions) for training, on one device or a ``(data, model)`` device mesh
(:mod:`.sharding`)."""
from .config import ArchConfig, MoEConfig
from .sharding import (
    ShardingRules,
    param_shardings,
    production_rules,
    shard,
    use_sharding,
)
from .stubs import make_inputs, synthetic_embeddings, synthetic_tokens
from .transformer import (
    count_params,
    decode_step,
    forward,
    init_cache,
    init_params,
    lm_loss,
    params_from_numpy,
    prefill,
)
