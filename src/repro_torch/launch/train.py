"""Training launcher: a decoder LM trained with AdamW on one device or a
``(data, model)`` device mesh.

The port of :mod:`repro.launch.train`.  On the card (the default device):
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 30 --batch 8 --seq 512 --checkpoint-dir /tmp/ckpt
On four cards, one process each (tensor parallelism 2, data parallelism 2):
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch granite-moe-1b-a400m --model-parallel 2 --checkpoint-dir /tmp/ckpt
On the CPU, at smoke scale:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --reduced --device cpu --steps 30 --batch 4 --seq 64

Features, as in the reference: deterministic resumable data stream,
atomic checkpoints + auto-resume, retrying step runner with straggler
monitor, optional int8 error-feedback gradient compression (on the
gradient after the data-parallel reduction).  The loss and its gradients
are plain PyTorch ops (autograd), as the reference differentiates plain
jnp ops: no hand-written kernel has a backward.

With a process group of more than one rank (torchrun's environment, or a
group the caller started) the trainer builds ``make_mesh_for(world,
--model-parallel)`` with the reference's rules, places the parameters
under ``param_shardings``, shards each batch over ``data`` and runs the
model under ``use_sharding``; the optimizer state takes the parameters'
placements (the reference's trainer has no ZeRO-1 either: only its
dry-run shards the moments over ``data``).  Every rank logs; rank 0
prints ``FINAL``.
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import torch
import torch.distributed as dist

from ..checkpoint.checkpointer import Checkpointer
from ..configs import ARCH_IDS, get_config
from ..data.pipeline import LMDataPipeline
from ..device import resolve_device
from ..models import (
    init_params,
    lm_loss,
    param_shardings,
    production_rules,
    use_sharding,
)
from ..models.sharding import distribute, shard
from ..optim import adamw, compress_grads, decompress_grads, init_error_feedback
from ..optim.schedule import warmup_cosine
from ..runtime.fault_tolerance import ResilientRunner, StragglerMonitor
from ..tree import leaves, tree_map, unflatten
from .mesh import init_process_group, make_mesh_for

log = logging.getLogger("repro_torch.train")


def build_trainer(cfg, mesh=None, rules=None, lr=3e-4, total_steps=10_000,
                  grad_compression: str | None = None):
    """Returns ``(init_opt, step_fn)``; ``step_fn(params, opt, ef, batch)
    -> (loss, params, opt, ef)`` is one AdamW step under the reference's
    warmup-cosine schedule.  With a ``mesh`` the step runs under
    ``use_sharding(mesh, rules)`` on DTensor parameters: the batch is
    sharded over the rules' batch axes, the loss made whole, and each
    gradient reduced to its parameter's placements (the data-parallel
    all-reduce) before compression and the update."""
    init_opt, update = adamw(lr=warmup_cosine(lr, min(100, total_steps // 10 + 1), total_steps))

    def step_fn(params, opt, ef, batch):
        with use_sharding(mesh, rules):
            return _step(params, opt, ef, batch)

    def _step(params, opt, ef, batch):
        if mesh is not None:
            batch = {k: shard(v, "batch", *(None,) * (v.dim() - 1))
                     for k, v in batch.items()}
        with torch.enable_grad():
            p = tree_map(lambda t: t.detach().requires_grad_(), params)
            loss = lm_loss(cfg, p, batch)
            if mesh is not None:
                loss = loss.full_tensor()
            grads = torch.autograd.grad(loss, leaves(p))
        if mesh is not None:  # the data-parallel reduction
            grads = [g.redistribute(w.device_mesh, w.placements)
                     for g, w in zip(grads, leaves(p))]
        grads = unflatten(params, grads)
        with torch.no_grad():
            if grad_compression == "int8":
                q, ef = compress_grads(grads, ef)
                grads = decompress_grads(q)
            params, opt = update(grads, opt, params)
        return loss.detach(), params, opt, ef

    return init_opt, step_fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--grad-compression", choices=["int8"], default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' to "
                         "run on the CPU)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    dev_type = torch.device("cuda" if args.device is None else args.device).type
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_process_group(dev_type)  # torchrun's environment
    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_dev % args.model_parallel:
        raise ValueError(f"--model-parallel {args.model_parallel} does not divide "
                         f"the world size {n_dev}")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = make_mesh_for(n_dev, args.model_parallel, dev.type) if n_dev > 1 else None
    rules = production_rules() if mesh is not None else None

    data = LMDataPipeline(cfg, args.batch, args.seq, seed=args.seed, device=dev)
    ckpt = Checkpointer(args.checkpoint_dir) if args.checkpoint_dir else None

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    if mesh is not None:
        params = distribute(params, param_shardings(params, mesh, rules))
    init_opt, step_fn = build_trainer(
        cfg, mesh, rules, lr=args.lr, total_steps=args.steps,
        grad_compression=args.grad_compression,
    )
    opt = init_opt(params)
    ef = init_error_feedback(params) if args.grad_compression else None

    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        state = ckpt.restore({"params": params, "opt": opt, "data": data.state_dict()})
        params, opt = state["params"], state["opt"]
        data.load_state_dict(state["data"])
        start_step = data.step
        log.info("resumed from step %d", start_step)

    def run_step(state, batch):
        params, opt, ef = state
        loss, params, opt, ef = step_fn(params, opt, ef, batch)
        return (params, opt, ef), {"loss": float(loss)}

    def save(step, state):
        if ckpt:
            params, opt, ef = state
            data.step = step
            ckpt.save(step, {"params": params, "opt": opt, "data": data.state_dict()})

    def restore():
        state = ckpt.restore({"params": params, "opt": opt, "data": data.state_dict()})
        data.load_state_dict(state["data"])
        return data.step, (state["params"], state["opt"], ef)

    def no_checkpoint():
        raise RuntimeError("no ckpt")

    runner = ResilientRunner(
        step_fn=run_step,
        save_fn=save,
        restore_fn=restore if ckpt else no_checkpoint,
        checkpoint_every=args.checkpoint_every,
        monitor=StragglerMonitor(),
    )

    t0 = time.time()
    state, metrics = runner.run(
        (params, opt, ef), lambda s: data.peek(s), start_step, args.steps - start_step
    )
    dt = time.time() - t0
    losses = [m["loss"] for m in metrics]
    if losses:
        log.info(
            "rank=%d/%d steps=%d first_loss=%.4f last_loss=%.4f wall=%.1fs (%.2f s/step)",
            rank, n_dev, len(losses), losses[0], losses[-1], dt, dt / max(len(losses), 1),
        )
        if rank == 0:
            print(f"FINAL loss={losses[-1]:.4f} first={losses[0]:.4f} steps={len(losses)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
