"""End-to-end GNN training on a compiled Program.

`repro_torch.compile()` runs the model-level mapper (one dataflow *per
layer* via dynamic programming over inter-layer transition costs — paper
Sec. 4.4), lowers the winning `ModelSchedule` to executable knobs, and
returns a frozen `Program` already bound to the graph; `program.train_step`
then trains a 2-layer GCN on a node-classification task through the
Program's shared executable cache: the step (autograd through the eager
tier's plain PyTorch ops, as the reference differentiates its jnp ops) is
built **once** on the first step and every later step — every later
*epoch* — reuses it (the second epoch asserts a
`repro_torch.trace_count()` delta of exactly 0).

    PYTHONPATH=src python -m repro_torch.examples.train_gnn_dataflow [--dataset cora] [--device cpu]
"""
import argparse

import torch

import repro_torch
from repro_torch.gnn import GNNConfig
from repro_torch.gnn.model import make_node_classification_task
from repro_torch.graphs import load_dataset


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20, help="steps per epoch")
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    g, spec = load_dataset(args.dataset)

    # 1. compile: mapper search (DP over transition costs) + lowering +
    #    graph binding, in one call
    cfg = GNNConfig(kind="gcn", f_in=spec.n_features, hidden=args.hidden,
                    n_classes=args.classes)
    program = repro_torch.compile(cfg, graph=g, objective="cycles",
                                  device=args.device)
    homo = program.schedule.shared_baseline  # homogeneous best, same sweep
    print(f"{args.dataset}: compiled program")
    print(program)
    print(
        f"  heterogeneous: {program.stats.cycles:.0f} cycles "
        f"({program.stats.transition_cycles:.0f} in transitions, "
        f"{program.stats.n_relayouts} relayouts)"
    )
    print(f"  homogeneous best: {homo.stats.cycles:.0f} cycles "
          f"({homo.layers[0].dataflow.to_string()})")
    print(f"  exec policies: {[s.policy for s in program.specs]}")

    # 2. train a 2-layer GCN through the compiled program's own step — the
    #    built step lives in the Program's executable cache
    x, labels, mask = make_node_classification_task(
        g, spec.n_features, args.classes, device=program.device
    )
    params = program.init(torch.Generator().manual_seed(0))

    for epoch in range(args.epochs):
        traces_before = repro_torch.trace_count()
        for i in range(args.steps):
            loss, params = program.train_step(
                params, x, labels, mask, lr=args.lr
            )
            if i % 10 == 0 or i == args.steps - 1:
                print(f"  epoch {epoch} step {i:3d} loss {float(loss):.4f}")
        delta = repro_torch.trace_count() - traces_before
        print(f"  epoch {epoch}: {delta} new builds")
        if epoch > 0 and delta != 0:
            # the executable cache must make warm epochs build nothing
            raise RuntimeError(
                f"epoch {epoch} took {delta} new builds; the train-step "
                f"executable should have been cached after epoch 0"
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
