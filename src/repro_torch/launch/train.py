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
jnp ops: no hand-written kernel has a backward.  On the card, alone or
on an NCCL mesh, the step is a CUDA graph that owns the training state, as
the reference jits its step and donates the state to it
(:class:`TrainStep`).  A step that fails in
its replay raises ``CudaKernelError``, which the runner re-raises without
a retry: the state may be half written, and a restart resumes from the
latest checkpoint.

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

from ..capture import CapturedGraph, placement
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
from ..models.transformer import captures_train
from ..optim import adamw, compress_grads, decompress_grads, init_error_feedback
from ..optim.schedule import warmup_cosine
from ..runtime.fault_tolerance import ResilientRunner, StragglerMonitor
from ..tree import leaf_paths, leaves, tree_map, unflatten
from .mesh import init_process_group, make_mesh_for

log = logging.getLogger("repro_torch.train")


def build_trainer(cfg, mesh=None, rules=None, lr=3e-4, total_steps=10_000,
                  grad_compression: str | None = None):
    """Returns ``(init_opt, step_fn)``; ``step_fn(params, opt, ef, batch)
    -> (loss, params, opt, ef)`` is one AdamW step under the reference's
    warmup-cosine schedule, a :class:`TrainStep`.  With a ``mesh`` the
    step runs under ``use_sharding(mesh, rules)`` on DTensor parameters:
    the batch is sharded over the rules' batch axes, the loss made whole,
    and each gradient reduced to its parameter's placements (the
    data-parallel all-reduce) before compression and the update."""
    init_opt, update = adamw(lr=warmup_cosine(lr, min(100, total_steps // 10 + 1), total_steps))

    def step(params, opt, ef, batch, in_place=False):
        with use_sharding(mesh, rules):
            return _step(params, opt, ef, batch, in_place)

    def _step(params, opt, ef, batch, in_place):
        if mesh is not None:
            batch = {k: shard(v, "batch", *(None,) * (v.dim() - 1))
                     for k, v in batch.items()}
        with torch.enable_grad():
            p = tree_map(lambda t: t.detach().requires_grad_(), params)
            loss = lm_loss(cfg, p, batch)
            if mesh is not None:
                loss = loss.full_tensor()
            # a leaf the loss does not use (olmo-1b's non-parametric
            # norms) gets a zero gradient, as jax.grad gives it
            grads = torch.autograd.grad(loss, leaves(p), allow_unused=True,
                                        materialize_grads=True)
        if mesh is not None:  # the data-parallel reduction
            grads = [g.redistribute(w.device_mesh, w.placements)
                     for g, w in zip(grads, leaves(p))]
        grads = unflatten(params, grads)
        with torch.no_grad():
            if grad_compression == "int8":
                q, ef = compress_grads(grads, ef, in_place)
                grads = decompress_grads(q)
            params, opt = update(grads, opt, params, in_place)
        return loss.detach(), params, opt, ef

    return init_opt, TrainStep(cfg, mesh, step)


class TrainStep:
    """:func:`build_trainer`'s step, the counterpart of the reference's
    ``jax.jit(step_fn, donate_argnums=(0, 1, 2))``.

    Where :func:`~repro_torch.models.transformer.captures_train` holds (a
    CUDA device, no mesh or an NCCL one, no float32 MoE block) the step is
    a CUDA graph (for an MoE arch the router's aux loss and the grouped
    expert products' backward inside it; on a mesh the batch's ``shard``,
    the loss's ``full_tensor`` and the gradients' ``redistribute``, with
    their collectives), captured on the first call for each shape key (the
    paths, shapes, dtypes and devices of every leaf of the state and the
    batch, and each DTensor leaf's mesh and placements) and replayed by
    every later call with that key.  On a mesh the graph records the
    function of this rank's local shards
    (:class:`~repro_torch.capture.LocalShards`).  The state is
    donated: the first call's params, opt and ef tensors become the graph's
    buffers, each replay writes the new state into them in place
    (:func:`~repro_torch.optim.adamw`'s and
    :func:`~repro_torch.optim.compress_grads`'s ``in_place``, the same bits
    as the fresh tensors of :meth:`eager`), and the step returns those
    buffers, with the loss copied out.  A call whose state is those very
    tensors copies nothing in; any other state (a restore, a fresh init) is
    copied in.  So one copy of the state lives on the card, and a caller that
    keeps a state across a step clones it first, as a donated JAX array is
    gone after the call.  The capture's warm-up runs the step with its writes
    left out, so it leaves the state as it found it with no copy of it (its
    cached memory goes back to the card before the capture).  Elsewhere (the CPU, a
    ``gloo`` mesh, a float32 MoE arch) the step is :meth:`eager`.
    ``graphs`` holds one graph per key that has run."""

    def __init__(self, cfg, mesh, step):
        self.cfg, self.mesh, self._step = cfg, mesh, step
        self.graphs: dict = {}

    def eager(self, params, opt, ef, batch):
        """The uncaptured step: fresh tensors, the arguments untouched."""
        return self._step(params, opt, ef, batch)

    def flat_step(self, args, in_place=True):
        """The step as a function of the leaves of ``args`` (``((params,
        opt, ef), batch)``) returning the loss: what the graph captures,
        with the state written in place (``in_place``)."""
        def fn(*flat):
            (p, o, e), b = unflatten(args, flat)
            return self._step(p, o, e, b, in_place)[0]
        return fn

    def __call__(self, params, opt, ef, batch):
        state = (params, opt, ef)
        if not captures_train(self.cfg, leaves(params)[0].device, self.mesh):
            return self.eager(params, opt, ef, batch)
        args = (state, batch)
        key = tuple((path, tuple(t.shape), t.dtype, t.device, placement(t))
                    for path, t in leaf_paths(args))
        n = len(leaves(state))
        graph = self.graphs.get(key)
        if graph is None:

            graph = CapturedGraph(self.flat_step(args), leaves(args), donated=n,
                                  warmup=self.flat_step(args, in_place=False))
        loss = graph(*leaves(args))
        self.graphs[key] = graph  # kept once it has run
        return (loss, *unflatten(state, graph.donated))


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
        # fresh tensors, copied into a captured step's buffers; the error
        # feedback starts from zero again, as it is not checkpointed
        state = ckpt.restore({"params": params, "opt": opt, "data": data.state_dict()})
        data.load_state_dict(state["data"])
        ef0 = init_error_feedback(state["params"]) if args.grad_compression else None
        return data.step, (state["params"], state["opt"], ef0)

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
