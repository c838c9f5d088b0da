"""The port's LM on a device mesh, on the CPU: four ``gloo`` processes, one
per device, as on four cards (``test_torch_distributed_train.py`` holds the
expert-parallel MoE against the reference's, the elastic restore and the
trainer).

Each fixture starts one group of processes (``repro_torch.launch.mesh.spawn``:
``file://`` rendezvous in a temporary directory, a process-group timeout
of ``PG_S``, one intra-op thread a process, a join timeout of ``JOIN_S``)
that runs every check of one mesh shape ((2, 2); (1, 4) under the
reference's production rules and under its tuned rules, whose residual
stream is sharded over the sequence); the tests read its results.  Weights come from
``repro.models.init_params`` (numpy, then ``params_from_numpy``).  All
reduced configs, float32; the MoE with capacity for every token, as the
unsharded port's ragged path never drops.

Tolerances, against the unsharded port on the same weights and batch:
- sharded prefill logits and the decode cache it builds: 1e-4 absolute;
- loss and gradients, data- and tensor-parallel, against the whole batch
  on one process: 1e-5;
- xlstm-1.3b, whose reduced model amplifies a rounding through its
  exponential gates: relative L2 1e-3, as in ``test_torch_lm_kinds.py``.

The same sharded results are also held against the reference itself
(``repro.models`` on the same weights, batch and MoE settings: its prefill
logits and cache, and ``jax.value_and_grad`` of its ``lm_loss``), at
``test_torch_lm_kinds.py``'s whole-model tolerances: logits and cache
rtol 2e-4, atol 2e-5; loss rtol 2e-4; gradients rtol 2e-4, atol 2e-4;
xlstm-1.3b by relative L2 at 1e-3.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn

ARCHS = ("smollm-135m", "granite-moe-1b-a400m", "recurrentgemma-2b", "xlstm-1.3b")
B, S = 4, 8
TOL = 1e-4
GRAD_TOL = 1e-5
XLSTM_REL_L2 = 1e-3
#: What a group of four ``gloo`` ranks is allowed on a loaded machine (the
#: tier-1 run puts five other test workers beside them, each with its own
#: intra-op threads): ``JOIN_S`` for the whole group to finish, ``PG_S``
#: for one rank to wait in a collective for the slowest.  A group alone
#: takes 30-90 s; the 120 s join and the default 60 s collective wait were
#: overrun under that load.
JOIN_S = 600
PG_S = 300


def _port_cfg(arch, aux=True):
    """The reduced config; the MoE with capacity for every token (the
    unsharded port's ragged path never drops), and no aux loss where the
    data axis splits the batch (the reference averages per-shard aux)."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import MoEConfig

    cfg = get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = cfg.with_(moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=8.0,
                                      router_aux_weight=0.01 if aux else 0.0))
    return cfg


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _full(t) -> np.ndarray:
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.detach().float().numpy()


def _whole(got, want) -> list:
    """The sharded leaves ``got``, whole, as numpy, in ``want``'s shapes."""
    got = [_full(t) for t in got]
    for i, (g, w) in enumerate(zip(got, want)):
        if g.ndim == 5 and g.shape[-2] != w.shape[-2]:
            # a KV cache under TP head alignment holds each KV head ``rep``
            # times in a row (the reference's replicated KV heads)
            rep = g.shape[-2] // w.shape[-2]
            copies = g.reshape(*g.shape[:-2], w.shape[-2], rep, g.shape[-1])
            assert (copies == copies[..., :1, :]).all()
            got[i] = copies[..., 0, :]
    return got


def _errors(got, want) -> dict:
    want = [w.detach().float().numpy() for w in want]
    got = _whole(got, want)
    return {"max_abs": max(float(np.abs(g - w).max()) for g, w in zip(got, want)),
            "rel_l2": max(_rel_l2(g, w) for g, w in zip(got, want))}


# ---------------------------------------------------------------------------
# Rank bodies (run in the spawned processes)
# ---------------------------------------------------------------------------


def _mesh(model_parallel, sequence_parallel=False):
    """A ``(data, model)`` mesh over this group with the reference's
    production rules, or its tuned rules (Megatron sequence parallelism)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.sharding import production_rules, tuned_rules

    rules = tuned_rules("any") if sequence_parallel else production_rules()
    return make_mesh_for(dist.get_world_size(), model_parallel, "cpu"), rules


def _model_checks(model_parallel, trees, inputs, labels, sequence_parallel=False):
    """Per arch: sharded prefill (logits, cache) and the loss and gradients
    against the unsharded port on the same weights and batch."""
    from repro_torch.models import lm_loss, params_from_numpy, prefill, use_sharding
    from repro_torch.models.sharding import distribute, param_shardings, shard
    from repro_torch.tree import leaf_paths, leaves, tree_map

    mesh, rules = _mesh(model_parallel, sequence_parallel)
    out = {}
    for arch, tree in trees.items():
        cfg = _port_cfg(arch, aux=mesh.size(0) == 1)
        params = params_from_numpy(tree, "cpu")
        x, y = torch.as_tensor(inputs[arch]), torch.as_tensor(labels)
        with torch.no_grad():
            ref_logits, ref_cache = prefill(cfg, params, x)
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        ref_loss = lm_loss(cfg, p, {"inputs": x, "labels": y})
        ref_grads = torch.autograd.grad(ref_loss, leaves(p))
        with use_sharding(mesh, rules):
            sp = distribute(params, param_shardings(params, mesh, rules))
            with torch.no_grad():
                logits, cache = prefill(cfg, sp, x)
            placed = {"/".join(map(str, k)): str(v.placements) for k, v in leaf_paths(sp)}
            sp = tree_map(lambda t: t.detach().requires_grad_(), sp)
            batch = {"inputs": shard(x, "batch", *(None,) * (x.dim() - 1)),
                     "labels": shard(y, "batch", None)}
            loss = lm_loss(cfg, sp, batch).full_tensor()
            grads = torch.autograd.grad(loss, leaves(sp))
        out[arch] = {
            "logits": _errors([logits], [ref_logits]),
            "cache": _errors(leaves(cache), leaves(ref_cache)),
            "loss": abs(float(loss) - float(ref_loss)),
            "grads": _errors(grads, ref_grads),
            "placements": placed,
            # the sharded results themselves, for the reference's
            "whole": {"logits": _full(logits),
                      "cache": _whole(leaves(cache), leaves(ref_cache)),
                      "loss": float(loss), "grads": [_full(g) for g in grads]},
        }
    return out


# ---------------------------------------------------------------------------
# Fixtures: one process group each
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_models():
    """Reference weights (numpy trees) and inputs per arch."""
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models import MoEConfig as RefMoEConfig
    from repro.models import init_params as ref_init_params

    rng = np.random.default_rng(0)
    trees, inputs = {}, {}
    for arch in ARCHS:
        cfg = ref_get_config(arch).reduced()
        if cfg.moe is not None:
            cfg = cfg.with_(moe=RefMoEConfig(n_experts=4, top_k=2, capacity_factor=8.0))
        trees[arch] = jax.tree_util.tree_map(np.asarray, ref_init_params(cfg, jax.random.PRNGKey(0)))
        if cfg.embedded_inputs:
            inputs[arch] = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
        else:
            inputs[arch] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int64)
    labels = rng.integers(0, 256, (B, S)).astype(np.int64)
    return trees, inputs, labels


@pytest.fixture(scope="module")
def ref_results(ref_models):
    """The reference's own results on the same weights and batch, with
    the aux loss on and off (the MoE settings of ``_port_cfg``): prefill
    logits and cache leaves, the loss and the gradient leaves."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.models import MoEConfig as RefMoEConfig
    from repro.models import lm_loss as ref_lm_loss
    from repro.models import prefill as ref_prefill

    trees, inputs, labels = ref_models
    out = {}
    for arch in ARCHS:
        base = ref_get_config(arch).reduced()
        for aux in (True, False):
            cfg = base
            if cfg.moe is not None:
                cfg = cfg.with_(moe=RefMoEConfig(n_experts=4, top_k=2, capacity_factor=8.0,
                                                 router_aux_weight=0.01 if aux else 0.0))
            elif not aux:
                out[arch, aux] = out[arch, True]
                continue
            p = jax.tree_util.tree_map(jnp.asarray, trees[arch])
            x = jnp.asarray(inputs[arch])
            batch = {"inputs": x, "labels": jnp.asarray(labels)}
            logits, cache = jax.jit(lambda p, x, c=cfg: ref_prefill(c, p, x))(p, x)
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b, c=cfg: ref_lm_loss(c, p, b)))(p, batch)
            leaves = jax.tree_util.tree_leaves
            out[arch, aux] = {"logits": np.asarray(logits),
                              "cache": [np.asarray(a) for a in leaves(cache)],
                              "loss": float(loss),
                              "grads": [np.asarray(g) for g in leaves(grads)]}
    return out


@pytest.fixture(scope="module")
def on_2x2(ref_models):
    trees, inputs, labels = ref_models
    return spawn(_model_checks, 4, 2, trees, inputs, labels, device_type="cpu",
                 join_timeout_s=JOIN_S, pg_timeout_s=PG_S)[0]


def _on_1x4(trees, inputs, labels):
    """(1, 4) under the production rules, then under the tuned rules (the
    residual stream sharded over the sequence), in one process group."""
    return {"1x4": _model_checks(4, trees, inputs, labels),
            "1x4-sp": _model_checks(4, trees, inputs, labels, sequence_parallel=True)}


@pytest.fixture(scope="module")
def on_1x4(ref_models):
    trees, inputs, labels = ref_models
    return spawn(_on_1x4, 4, trees, inputs, labels, device_type="cpu",
                 join_timeout_s=JOIN_S, pg_timeout_s=PG_S)[0]


# ---------------------------------------------------------------------------
# (c) the sharded forward, prefill and gradients against the unsharded port
# ---------------------------------------------------------------------------


def _held(res, arch, what, tol):
    if arch == "xlstm-1.3b":
        assert res[arch][what]["rel_l2"] <= XLSTM_REL_L2, res[arch][what]
    else:
        assert res[arch][what]["max_abs"] <= tol, res[arch][what]


SHAPES = ["2x2", "1x4", "1x4-sp"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_prefill_matches_unsharded(arch, shape, on_2x2, on_1x4):
    res = on_2x2 if shape == "2x2" else on_1x4[shape]
    _held(res, arch, "logits", TOL)
    _held(res, arch, "cache", TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_loss_and_gradients_match_the_whole_batch(arch, shape, on_2x2, on_1x4):
    res = on_2x2 if shape == "2x2" else on_1x4[shape]
    assert res[arch]["loss"] <= GRAD_TOL, res[arch]["loss"]
    _held(res, arch, "grads", GRAD_TOL)


REF_TOL = dict(rtol=2e-4, atol=2e-5)
REF_GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _held_against(arch, got, want, tol, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        if arch == "xlstm-1.3b":
            assert _rel_l2(g, w) <= XLSTM_REL_L2, (what, i, _rel_l2(g, w))
        else:
            np.testing.assert_allclose(g, w, **tol, err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_results_match_the_reference(arch, shape, on_2x2, on_1x4, ref_results):
    """The sharded prefill (logits, cache), loss and gradients against the
    reference's on the same weights and batch: the MoE with the aux loss on
    where the data axis is 1 wide, off on (2, 2), as ``_port_cfg``."""
    res = (on_2x2 if shape == "2x2" else on_1x4[shape])[arch]["whole"]
    ref = ref_results[arch, shape != "2x2"]
    _held_against(arch, [res["logits"]], [ref["logits"]], REF_TOL, "logits")
    _held_against(arch, res["cache"], ref["cache"], REF_TOL, "cache")
    np.testing.assert_allclose(res["loss"], ref["loss"], rtol=2e-4)
    _held_against(arch, res["grads"], ref["grads"], REF_GRAD_TOL, "grads")


def test_rules_really_split_the_parameters(on_2x2, on_1x4):
    """On (1, 4) the heads, d_ff, vocab and experts shard over ``model``;
    on (2, 2) too, and every parameter is replicated over ``data``."""
    for res in (on_2x2, on_1x4["1x4"]):
        # stacked leaves carry the layer axis first: (L, E, d, ff), (L, d, H D)
        pl = res["granite-moe-1b-a400m"]["placements"]
        assert pl["scanned/0/moe/experts_gate"] == "(Replicate(), Shard(dim=1))"
        assert pl["scanned/0/attn/wq"] == "(Replicate(), Shard(dim=2))"
        assert pl["scanned/0/attn/wo"] == "(Replicate(), Shard(dim=1))"
        assert pl["embeddings/embed"] == "(Replicate(), Shard(dim=0))"
        assert pl["scanned/0/ln1"] == "(Replicate(), Replicate())"
        assert (res["smollm-135m"]["placements"]["scanned/0/mlp/w_down"]
                == "(Replicate(), Shard(dim=1))")
    assert all(v.startswith("(Replicate()") for v in on_2x2["smollm-135m"]["placements"].values())
