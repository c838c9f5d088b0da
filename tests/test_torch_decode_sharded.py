"""Decode against a KV cache whose sequence is sharded over the model axis
(the reference dry-run's ``cache_shardings`` placement), on four ``gloo``
processes.

Two reduced configs on a (1, 4) mesh, each over several decode positions
after a prompt replayed unsharded:

- smollm-135m's at 3 query and 3 KV heads (head alignment refused, so the
  heads stay whole on every rank) over a 16-slot cache, 4 slots a rank:
  positions 3 to 6, so the new key lands first in rank 0's slice, then in
  rank 1's;
- smollm-135m's reduced heads (4 query heads over 1 KV head, padded to
  4 / 4 and sharded over the model axis, so q is gathered), with a
  local-attention layer of window 8 beside a global one: the local layer's
  ring buffer holds 8 slots, 2 a rank, and positions 3 to 12 wrap it.

Weights are the reference's own init (``repro.models.init_params``, as
numpy), tokens come from numpy with a seed.  Each rank's decode logits and
the whole cache afterwards are held within 1e-4 of the unsharded port, and
against the reference's ``decode_step`` over the same prompt and positions
at ``test_torch_lm_kinds.py``'s decode tolerance (rtol 2e-4, atol 2e-5);
each rank's cache bytes equal the local shard of ``cache_shardings``.  The
spawned processes import this module by name: no JAX at its top level.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn
from test_torch_distributed import JOIN_S, REF_TOL, TOL, _errors, _full, _held_against, _whole

B, PROMPT, S_MAX = 2, 3, 16
STEPS = {"whole_heads": 4, "windowed": 10}


def _cfg(name, get_config):
    """The config ``name`` from ``get_config`` (the port's or the reference's)."""
    base = get_config("smollm-135m").reduced()
    if name == "whole_heads":
        return base.with_(n_layers=2, n_heads=3, n_kv_heads=3, d_model=48)
    return base.with_(n_layers=2, block_pattern=("local", "attn"), window=8)


def _rank(trees, tokens):
    """Rank body: each config's decode on (1, 4) with the cache placed by
    ``cache_shardings``, against the same decode unsharded; the sharded
    logits and final cache are also returned whole."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.specs import cache_shardings, local_bytes_of
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, params_from_numpy, production_rules
    from repro_torch.models import use_sharding
    from repro_torch.models.attention import head_alignment
    from repro_torch.models.sharding import distribute, param_shardings
    from repro_torch.tree import leaves, tree_map

    mesh, rules = make_mesh_for(dist.get_world_size(), 4, "cpu"), production_rules()
    out = {}
    for name, steps in STEPS.items():
        cfg = _cfg(name, get_config)
        params = params_from_numpy(trees[name], "cpu")
        toks = torch.from_numpy(tokens[name])
        with torch.no_grad(), use_sharding(mesh, rules):
            # the cache's KV heads are aligned to the mesh (padded where
            # alignment applies), then filled by the prompt unsharded
            cache = init_cache(cfg, B, S_MAX, "cpu", place=False)
        with torch.no_grad():
            for i in range(PROMPT):
                _, cache = decode_step(cfg, params, cache, toks[:, i:i + 1], i)
            sharded_cache = tree_map(torch.clone, cache)
            want = []
            for i in range(PROMPT, PROMPT + steps):
                logits, cache = decode_step(cfg, params, cache, toks[:, i:i + 1], i)
                want.append(logits)
            with use_sharding(mesh, rules):
                placement = cache_shardings(cfg, sharded_cache, mesh, rules)
                sc = distribute(sharded_cache, placement)
                sp = distribute(params, param_shardings(params, mesh, rules))
                got = []
                for i in range(PROMPT, PROMPT + steps):
                    logits, sc = decode_step(cfg, sp, sc, toks[:, i:i + 1], i)
                    got.append(logits)
        out[name] = {"logits": _errors(got, want), "cache": _errors(leaves(sc), leaves(cache)),
                     "bytes": [local_bytes(sc), local_bytes_of(sharded_cache, placement)],
                     "whole_bytes": local_bytes(cache),
                     "aligned": head_alignment(cfg, 4),
                     "whole_logits": [_full(t) for t in got],
                     "whole_cache": [torch.from_numpy(_full(t)) for t in leaves(sc)]}
    return out


@pytest.fixture(scope="module")
def inputs():
    """The reference's weights (numpy trees) and the tokens, per config."""
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models import init_params as ref_init_params

    rng = np.random.default_rng(0)
    trees, tokens = {}, {}
    for name, steps in STEPS.items():
        cfg = _cfg(name, ref_get_config)
        trees[name] = jax.tree_util.tree_map(np.asarray,
                                             ref_init_params(cfg, jax.random.PRNGKey(0)))
        tokens[name] = rng.integers(0, cfg.vocab, (B, PROMPT + steps)).astype(np.int64)
    return trees, tokens


@pytest.fixture(scope="module")
def ranks(inputs):
    return spawn(_rank, 4, *inputs, device_type="cpu", join_timeout_s=JOIN_S)


@pytest.fixture(scope="module")
def ref_decodes(inputs):
    """The reference's ``decode_step`` over the same prompt and positions:
    the logits of each position after the prompt and the final cache."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.models import decode_step as ref_decode_step
    from repro.models import init_cache as ref_init_cache

    trees, tokens = inputs
    out = {}
    for name, steps in STEPS.items():
        cfg = _cfg(name, ref_get_config)
        p = jax.tree_util.tree_map(jnp.asarray, trees[name])
        cache, logits = ref_init_cache(cfg, B, S_MAX), []
        for i in range(PROMPT + steps):
            step, cache = ref_decode_step(cfg, p, cache, jnp.asarray(tokens[name][:, i:i + 1]), i)
            if i >= PROMPT:
                logits.append(np.asarray(step))
        out[name] = {"logits": logits,
                     "cache": [np.asarray(a) for a in jax.tree_util.tree_leaves(cache)]}
    return out


def test_decode_over_a_sequence_sharded_cache_matches_unsharded(ranks):
    for r, res in enumerate(ranks):
        for name, got in res.items():
            assert got["logits"]["max_abs"] <= TOL, (r, name, got["logits"])
            assert got["cache"]["max_abs"] <= TOL, (r, name, got["cache"])
            # each rank holds a quarter of every KV cache (the sequence over
            # the four model ranks), and nothing else of it
            assert got["bytes"][0] == got["bytes"][1] == got["whole_bytes"] // 4, (r, name)
    assert ranks[0]["whole_heads"]["aligned"] == (1, 1, False)  # heads whole
    assert ranks[0]["windowed"]["aligned"] == (4, 1, True)  # 1 KV head padded to 4


def test_decode_over_a_sequence_sharded_cache_matches_the_reference(ranks, ref_decodes):
    """Every rank's sharded logits at each position and its final cache,
    whole, against the reference's; the padded config's cache holds each
    KV head four times in a row, compared once."""
    for r, res in enumerate(ranks):
        for name, got in res.items():
            want = ref_decodes[name]
            _held_against("smollm-135m", got["whole_logits"], want["logits"], REF_TOL,
                          f"rank {r} {name} logits")
            _held_against("smollm-135m", _whole(got["whole_cache"], want["cache"]),
                          want["cache"], REF_TOL, f"rank {r} {name} cache")
