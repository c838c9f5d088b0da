"""recurrentgemma-2b's gradients at batch 2 on a (1, 4) mesh of four
``gloo`` processes, against the unsharded port on the same weights and
batch (float32, reduced config, 1e-5 as ``test_torch_distributed.py``).

With the RG-LRU gate products left where DTensor's matmul rule puts them,
the backward of this step raised ``This operation would remove or reshape
sharded dimension 0`` (the view of a gradient strided-sharded over the
flattened batch and sequence); ``rglru._gates`` now reduces them onto u's
channel placement.  ``test_torch_distributed.py`` runs batch 4, where the
view did not fail.  The spawned processes import this module by name.
"""
import torch

from repro_torch.launch.mesh import spawn
from test_torch_distributed import PG_S, GRAD_TOL, JOIN_S, _errors

B, S = 2, 8


def _rank():
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import init_params, lm_loss, production_rules, use_sharding
    from repro_torch.models.sharding import distribute, param_shardings, shard
    from repro_torch.tree import leaves, tree_map

    cfg = get_config("recurrentgemma-2b").reduced()
    mesh, rules = make_mesh_for(dist.get_world_size(), 4, "cpu"), production_rules()
    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, g, "cpu")
    x, y = (torch.randint(0, cfg.vocab, (B, S), generator=g) for _ in range(2))
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    want_loss = lm_loss(cfg, p, {"inputs": x, "labels": y})
    want = torch.autograd.grad(want_loss, leaves(p))
    with use_sharding(mesh, rules):
        sp = tree_map(lambda t: t.detach().requires_grad_(),
                      distribute(params, param_shardings(params, mesh, rules)))
        loss = lm_loss(cfg, sp, {"inputs": shard(x, "batch", None),
                                 "labels": shard(y, "batch", None)}).full_tensor()
        got = torch.autograd.grad(loss, leaves(sp))
    return {"loss": abs(float(loss) - float(want_loss)), "grads": _errors(got, want)}


def test_rglru_gradients_at_batch_two_on_a_model_axis_match_unsharded():
    for r, res in enumerate(spawn(_rank, 4, device_type="cpu", join_timeout_s=JOIN_S,
                                  pg_timeout_s=PG_S)):
        assert res["loss"] <= GRAD_TOL, (r, res)
        assert res["grads"]["max_abs"] <= GRAD_TOL, (r, res)
