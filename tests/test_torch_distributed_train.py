"""Expert parallelism, elastic checkpoints and the trainer of the port on
a device mesh, on the CPU: four ``gloo`` processes (two for the restore),
one per device, started as in ``test_torch_distributed.py`` (``file://``
rendezvous, a 60 s process-group timeout, one thread a process, a join
timeout).

Tolerances:
- ``moe_ep`` on a (1, 4) mesh against the reference's ``moe_ep`` on four
  JAX host devices (a subprocess): rtol 1e-4, atol 1e-5, the reference's
  own tolerance (``tests/test_models.py``), with and without drops; on a
  (2, 2) mesh with the aux loss on, the output, aux (rtol 1e-5) and the
  gradients of ``sum(out * c) + aux`` for the router, the experts and the
  input against ``jax.grad`` of the reference's, at the same tolerance;
- a checkpoint written on 4 ranks (2 x 2) restored on 2 (2 x 1), and by the
  reference's ``Checkpointer`` into single-process arrays: exact;
- ``launch.train --model-parallel 2`` on 4 ranks: parameters and optimizer
  state after 3 steps within 1e-5 of the one-process run; a run preempted
  after its step-2 checkpoint and restarted ``torch.equal`` to the
  straight one.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn
from test_torch_distributed import GRAD_TOL, JOIN_S, _full, _mesh, _port_cfg

# ---------------------------------------------------------------------------
# Rank bodies (run in the spawned processes)
# ---------------------------------------------------------------------------


def _moe_ep_checks(cases):
    """``moe_ffn(policy="auto")`` under each case's mesh, the weights placed
    by ``param_shardings`` and the input sharded over ``data``: the output
    and aux, whole; for a case with a cotangent ``c``, also the gradients
    of ``sum(out * c) + aux`` for the router, the experts and the input."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import params_from_numpy, use_sharding
    from repro_torch.models.config import ArchConfig, MoEConfig
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.sharding import distribute, param_shardings

    names = ("router", "experts_gate", "experts_up", "experts_down")
    out = []
    for case in cases:
        mesh, rules = _mesh(case["mesh"][1])
        cfg = ArchConfig(name="t", family="moe", n_layers=1, d_model=16, n_heads=2,
                         n_kv_heads=2, d_ff=32, vocab=64, block_pattern=("moe",),
                         moe=MoEConfig(n_experts=case["n_experts"], top_k=2,
                                       capacity_factor=case["capacity_factor"],
                                       router_aux_weight=case["aux_weight"]))
        p = params_from_numpy(case["params"], "cpu")
        grad = "c" in case
        with torch.set_grad_enabled(grad), use_sharding(mesh, rules):
            p = distribute(p, param_shardings(p, mesh, rules))
            rows = [Shard(0), Replicate()]
            x = distribute_tensor(torch.as_tensor(case["x"]), mesh, rows)
            if grad:
                for t in [x, *p.values()]:
                    t.requires_grad_()
            y, aux = moe_ffn(cfg, p, x)
            res = {"out": _full(y), "aux": float(_full(aux)),
                   "out_placements": str(y.placements)}
            if grad:
                c = distribute_tensor(torch.as_tensor(case["c"]), mesh, rows)
                loss = ((y * c).sum() + aux).full_tensor()
                gs = torch.autograd.grad(loss, [p[k] for k in names] + [x])
                res["grads"] = dict(zip(names + ("x",), (_full(g) for g in gs)))
        out.append(res)
    return out


def _elastic_save(model_parallel, tree, root):
    """Distribute the weights and a fresh AdamW state on the mesh and save
    them at step 1 (every rank calls ``save``; rank 0 writes)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models import params_from_numpy
    from repro_torch.models.sharding import distribute, param_shardings
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves

    mesh, rules = _mesh(model_parallel)
    params = params_from_numpy(tree, "cpu")
    sp = distribute(params, param_shardings(params, mesh, rules))
    opt = adamw()[0](sp)
    Checkpointer(root).save(1, {"params": sp, "opt": opt})
    return sorted(str(p.placements) for p in leaves(sp))


def _elastic_restore(model_parallel, root):
    """Restore the step-1 checkpoint onto this mesh, placed by
    ``param_shardings``; the parameters, whole, as numpy."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models import init_params
    from repro_torch.models.sharding import param_shardings
    from repro_torch.optim import adamw
    from repro_torch.tree import leaf_paths

    mesh, rules = _mesh(model_parallel)
    cfg = _port_cfg("granite-moe-1b-a400m")
    like = init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    shardings = param_shardings(like, mesh, rules)
    state = Checkpointer(root).restore({"params": like, "opt": adamw()[0](like)},
                                       shardings={"params": shardings})
    return {"/".join(map(str, k)): (_full(v), str(v.placements))
            for k, v in leaf_paths(state["params"])}


def _train_runs(root):
    """``launch.train.main`` under this process group (2 x 2 mesh): 3 steps
    straight, checkpoints at 2 and 3; then the run preempted after its
    step-2 checkpoint (a copy without step 3), restarted with the same
    flags."""
    import shutil

    import torch.distributed as dist

    from repro_torch.launch import train

    args = ["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--model-parallel", "2", "--checkpoint-every", "2",
            "--steps", "3"]
    train.main(args + ["--checkpoint-dir", f"{root}/straight"])
    train.main(args + ["--grad-compression", "int8", "--checkpoint-dir", f"{root}/int8"])
    if dist.get_rank() == 0:
        shutil.copytree(f"{root}/straight", f"{root}/resumed")
        shutil.rmtree(f"{root}/resumed/step_3")
    dist.barrier()
    train.main(args + ["--checkpoint-dir", f"{root}/resumed"])
    return True


# ---------------------------------------------------------------------------
# moe_ep against the reference's moe_ep, on four devices each
# ---------------------------------------------------------------------------

REF_MOE_EP = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.models.config import ArchConfig, MoEConfig
from repro.models.moe import init_moe, moe_ep
from repro.models.sharding import ShardingRules
rng = np.random.default_rng(3)
auto = (jax.sharding.AxisType.Auto,) * 2
rules = ShardingRules(batch=("data",), heads="model", d_ff="model", experts="model",
                      vocab="model")
cases = []
# (data, model), capacity factor, x's shape, experts, aux weight, gradients
for m, cf, shape, e, aux_w, grad in (
        ((1, 4), 8.0, (2, 8, 16), 4, 0.01, False),
        ((1, 4), 0.1, (2, 32, 16), 4, 0.01, False),
        ((1, 4), 8.0, (2, 8, 16), 3, 0.01, False),
        ((2, 2), 8.0, (4, 8, 16), 4, 0.01, True),
        ((2, 2), 1.0, (4, 16, 16), 4, 0.01, True)):
    mesh = jax.make_mesh(m, ("data", "model"), devices=jax.devices()[:4], axis_types=auto)
    cfg = ArchConfig(name="t", family="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
                     d_ff=32, vocab=64, block_pattern=("moe",),
                     moe=MoEConfig(n_experts=e, top_k=2, capacity_factor=cf,
                                   router_aux_weight=aux_w))
    p = init_moe(cfg, jax.random.PRNGKey(0))
    x = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    c = rng.standard_normal(shape).astype(np.float32)

    def loss(p, x):
        y, aux = moe_ep(cfg, p, x, mesh, rules)
        return jnp.sum(y * c) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                  has_aux=True))(p, jnp.asarray(x))
    extra = {"c": c, "grad_x": np.asarray(gx),
             **{"grad_" + k: np.asarray(v) for k, v in gp.items()}} if grad else {}
    np.savez(sys.argv[1] + f"/case{len(cases)}.npz", x=x, out=np.asarray(y), aux=float(aux),
             **{k: np.asarray(v) for k, v in p.items()}, **extra)
    cases.append([list(m), cf, e, aux_w])
print(json.dumps(cases))
"""


def _reference_subprocess(script, *args, devices=4):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", script, *args], capture_output=True, text=True,
                       env=env, cwd=root, timeout=JOIN_S)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def moe_ep_pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_ep")
    specs = _reference_subprocess(REF_MOE_EP, str(root))
    refs = [dict(np.load(root / f"case{i}.npz")) for i in range(len(specs))]
    cases = [{"mesh": m, "capacity_factor": cf, "n_experts": e, "aux_weight": aux_w,
              "x": r["x"], **({"c": r["c"]} if "c" in r else {}),
              "params": {k: r[k] for k in ("router", "experts_gate", "experts_up",
                                           "experts_down")}}
             for (m, cf, e, aux_w), r in zip(specs, refs)]
    return refs, spawn(_moe_ep_checks, 4, cases, device_type="cpu",
                       join_timeout_s=JOIN_S)[0]


MOE_EP_CASES = ["no_drops", "capacity_drops_tokens", "3_experts_padded_to_4",
                "2x2_aux", "2x2_aux_capacity_drops_tokens"]


@pytest.mark.parametrize("case", range(5), ids=MOE_EP_CASES)
def test_moe_ep_on_four_ranks_matches_the_references(case, moe_ep_pair):
    refs, got = moe_ep_pair
    np.testing.assert_allclose(got[case]["out"], refs[case]["out"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[case]["aux"], float(refs[case]["aux"]), rtol=1e-5)
    # merged over the model axis; the batch stays split over the data axis
    assert got[case]["out_placements"] == "(Shard(dim=0), Replicate())"


@pytest.mark.parametrize("case", [3, 4], ids=MOE_EP_CASES[3:])
def test_moe_ep_data_parallel_aux_and_gradients_match_the_references(case, moe_ep_pair):
    """On (2, 2) each data shard routes its own half of the batch: aux is
    the mean of the two halves' (the reference's ``pmean`` over model and
    data), and its gradient reaches the router once, not once a model
    shard."""
    refs, got = moe_ep_pair
    assert refs[case]["aux"] > 0
    for k, g in got[case]["grads"].items():
        np.testing.assert_allclose(g, refs[case]["grad_" + k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_moe_ep_capacity_drops_change_the_output(moe_ep_pair):
    """With capacity factor 0.1 tokens are dropped: the output differs from
    the dense oracle (the reference's ``test_capacity_drops_tokens``)."""
    from repro_torch.models.config import ArchConfig, MoEConfig
    from repro_torch.models.moe import moe_dense
    from repro_torch.models import params_from_numpy

    refs, got = moe_ep_pair
    cfg = ArchConfig(name="t", family="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
                     d_ff=32, vocab=64, block_pattern=("moe",),
                     moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=0.1))
    p = params_from_numpy({k: refs[1][k] for k in ("router", "experts_gate", "experts_up",
                                                   "experts_down")}, "cpu")
    dense, _ = moe_dense(cfg, p, torch.as_tensor(refs[1]["x"]))
    assert np.abs(got[1]["out"] - dense.numpy()).max() > 1e-4


def test_moe_ep_without_a_mesh_raises():
    from repro_torch.models.config import ArchConfig, MoEConfig
    from repro_torch.models.moe import init_moe, moe_ffn

    cfg = ArchConfig(name="t", family="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
                     d_ff=32, vocab=64, block_pattern=("moe",), moe=MoEConfig(4, 2))
    p = init_moe(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="use_sharding"):
        moe_ffn(cfg, p, torch.zeros(1, 2, 16), policy="ep")


# ---------------------------------------------------------------------------
# (d) elastic restore: saved on 4 ranks (2 x 2), restored on 2 (2 x 1)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def granite_tree():
    """The reference's reduced granite-moe weights, as numpy."""
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models import MoEConfig as RefMoEConfig
    from repro.models import init_params as ref_init_params

    cfg = ref_get_config("granite-moe-1b-a400m").reduced()
    cfg = cfg.with_(moe=RefMoEConfig(n_experts=4, top_k=2, capacity_factor=8.0))
    return jax.tree_util.tree_map(np.asarray, ref_init_params(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def elastic(granite_tree, tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    saved = spawn(_elastic_save, 4, 2, granite_tree, str(root), device_type="cpu",
                  join_timeout_s=JOIN_S)[0]
    restored = spawn(_elastic_restore, 2, 1, str(root), device_type="cpu",
                     join_timeout_s=JOIN_S)[0]
    return saved, restored, root


def test_elastic_restore_four_to_two_ranks_is_exact(elastic, granite_tree):
    from repro_torch.tree import leaf_paths

    saved, restored, _ = elastic
    trees = granite_tree
    want = {"/".join(map(str, k)): np.asarray(v) for k, v in leaf_paths(trees)}
    assert set(want) == set(restored)
    for key, (arr, placements) in restored.items():
        assert np.array_equal(arr, want[key]), key
    # placed by the new mesh's rules: model axis of size 1, data of 2
    assert restored["scanned/0/moe/experts_gate"][1] == "(Replicate(), Shard(dim=1))"
    assert any("Shard" in p for p in saved)


def test_the_reference_restores_the_ports_sharded_checkpoint(elastic, granite_tree):
    """The files the four ranks wrote restore through the reference's
    ``Checkpointer`` into single-process arrays, exact."""
    import jax

    from repro.checkpoint import Checkpointer as RefCheckpointer
    from repro.optim import adamw as ref_adamw

    _, _, root = elastic
    trees = granite_tree
    like = jax.tree_util.tree_map(jax.numpy.asarray, trees)
    state = RefCheckpointer(root).restore({"params": like, "opt": ref_adamw()[0](like)})
    got = jax.tree_util.tree_leaves(state["params"])
    want = jax.tree_util.tree_leaves(trees)
    assert len(got) == len(want)
    assert all(np.array_equal(np.asarray(g), w) for g, w in zip(got, want))
    assert int(state["opt"].step) == 0
    assert all(not np.asarray(m).any() for m in jax.tree_util.tree_leaves(state["opt"].m))


# ---------------------------------------------------------------------------
# launch.train --model-parallel 2 on four ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from repro_torch.launch import train

    root = tmp_path_factory.mktemp("train")
    spawn(_train_runs, 4, str(root), device_type="cpu",
          join_timeout_s=JOIN_S)
    one = ["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--batch", "4",
           "--seq", "16", "--steps", "3"]
    assert train.main(one + ["--checkpoint-dir", f"{root}/one"]) == 0
    assert train.main(one + ["--grad-compression", "int8",
                             "--checkpoint-dir", f"{root}/one_int8"]) == 0
    return root


def _final_state(path):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import _load_npy

    ck = Checkpointer(path)
    step = ck.latest_step()
    manifest = json.loads((Path(path) / f"step_{step}" / "manifest.json").read_text())
    return step, {l["key"]: _load_npy(Path(path) / f"step_{step}" / "arrays" / l["file"],
                                      l["dtype"]) for l in manifest["leaves"]}


def test_train_model_parallel_matches_one_process(trained):
    step_mp, mp = _final_state(trained / "straight")
    step_one, one = _final_state(trained / "one")
    assert step_mp == step_one == 3
    assert set(mp) == set(one)
    for key in mp:
        np.testing.assert_allclose(mp[key].float().numpy(), one[key].float().numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=key)


def test_train_model_parallel_int8_compression_matches_one_process(trained):
    """int8 error-feedback compression on the reduced gradient (DTensor
    leaves, one scale a whole leaf) against the one-process run after 3
    steps: 99.9% of each leaf's parameters within 1e-5; the rest are
    elements whose gradient rounds to the next int8 step on one side (the
    same gradient to 1e-5, a discontinuous quantizer), and an AdamW step
    moves a parameter by at most about lr, so none differs by more than
    3 steps x lr (3e-4, the trainer's default)."""
    _, mp = _final_state(trained / "int8")
    _, one = _final_state(trained / "one_int8")
    for key in mp:
        if key.startswith("params"):
            diff = np.abs(mp[key].float().numpy() - one[key].float().numpy())
            tol = GRAD_TOL * (1 + np.abs(one[key].float().numpy()))
            assert np.mean(diff <= tol) >= 0.999, key
            assert diff.max() <= 3 * 3e-4, key


def test_train_model_parallel_resume_is_bitwise(trained):
    _, straight = _final_state(trained / "straight")
    step, resumed = _final_state(trained / "resumed")
    assert step == 3
    assert all(torch.equal(straight[k], resumed[k]) for k in straight)


def test_model_parallel_that_does_not_divide_the_world_raises():
    from repro_torch.launch import train

    with pytest.raises(ValueError, match="does not divide"):
        train.main(["--reduced", "--device", "cpu", "--steps", "1", "--model-parallel", "2"])
