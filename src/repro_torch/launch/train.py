"""Training launcher: a decoder LM trained with AdamW on one device.

The port of :mod:`repro.launch.train`.  On the card (the default device):
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 30 --batch 8 --seq 512 --checkpoint-dir /tmp/ckpt
On the CPU, at smoke scale:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --reduced --device cpu --steps 30 --batch 4 --seq 64

Features, as in the reference: deterministic resumable data stream,
atomic checkpoints + auto-resume, retrying step runner with straggler
monitor, optional int8 error-feedback gradient compression.  The loss and
its gradients are plain PyTorch ops (autograd), as the reference
differentiates plain jnp ops: no hand-written kernel has a backward.  The
port trains on one device; ``--model-parallel`` other than 1 (the
reference's mesh, sharded parameters and ZeRO-1 optimizer state) waits
for the sharding item of ROADMAP Queue 1.
"""
from __future__ import annotations

import argparse
import logging
import time

import torch

from ..checkpoint.checkpointer import Checkpointer
from ..configs import ARCH_IDS, get_config
from ..data.pipeline import LMDataPipeline
from ..device import resolve_device
from ..models import init_params, lm_loss
from ..optim import adamw, compress_grads, decompress_grads, init_error_feedback
from ..optim.schedule import warmup_cosine
from ..runtime.fault_tolerance import ResilientRunner, StragglerMonitor
from ..tree import leaves, tree_map, unflatten

log = logging.getLogger("repro_torch.train")


def build_trainer(cfg, lr=3e-4, total_steps=10_000,
                  grad_compression: str | None = None):
    """Returns ``(init_opt, step_fn)``; ``step_fn(params, opt, ef, batch)
    -> (loss, params, opt, ef)`` is one AdamW step under the reference's
    warmup-cosine schedule.  The reference's ``mesh`` / ``rules`` come
    with the sharding item (ROADMAP Queue 1)."""
    init_opt, update = adamw(lr=warmup_cosine(lr, min(100, total_steps // 10 + 1), total_steps))

    def step_fn(params, opt, ef, batch):
        with torch.enable_grad():
            p = tree_map(lambda t: t.detach().requires_grad_(), params)
            loss = lm_loss(cfg, p, batch)
            grads = unflatten(params, torch.autograd.grad(loss, leaves(p)))
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
    if args.model_parallel != 1:
        raise NotImplementedError(
            "multi-device training (--model-parallel, a device mesh, sharded "
            "parameters) waits for the sharding item of ROADMAP Queue 1"
        )
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    data = LMDataPipeline(cfg, args.batch, args.seq, seed=args.seed, device=dev)
    ckpt = Checkpointer(args.checkpoint_dir) if args.checkpoint_dir else None

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    init_opt, step_fn = build_trainer(
        cfg, lr=args.lr, total_steps=args.steps,
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
            "steps=%d first_loss=%.4f last_loss=%.4f wall=%.1fs (%.2f s/step)",
            len(losses), losses[0], losses[-1], dt, dt / max(len(losses), 1),
        )
        print(f"FINAL loss={losses[-1]:.4f} first={losses[0]:.4f} steps={len(losses)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
