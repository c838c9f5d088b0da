"""End-to-end LM training, resumable across a preemption.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu] [--checkpoint-dir DIR]

It trains the reduced smollm-135m (batch 4 x 64) for 20 steps with a
checkpoint every 10, simulates a preemption, then resumes to 40 steps from
the atomic checkpoint.  The checkpoints go to ``--checkpoint-dir``
(default: ``build/train_lm_example`` in the checkout, emptied first).  The
full-size run is the same code path:

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 300 --batch 32 --seq 512 --checkpoint-dir build/ckpt_135m
"""
import argparse
import shutil
from pathlib import Path

from repro_torch.launch.train import main as train_main

CHECKPOINT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_lm_example"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--checkpoint-dir", default=str(CHECKPOINT_DIR))
    args = ap.parse_args(argv)
    shutil.rmtree(args.checkpoint_dir, ignore_errors=True)
    base = ["--arch", "smollm-135m", "--reduced", "--batch", "4", "--seq", "64",
            "--checkpoint-dir", args.checkpoint_dir, "--checkpoint-every", "10"]
    if args.device is not None:
        base += ["--device", args.device]
    print("=== phase 1: train 20 steps, checkpointing every 10 ===")
    train_main(base + ["--steps", "20"])
    print("=== phase 2: 'preemption' -> resume to 40 steps from the checkpoint ===")
    return train_main(base + ["--steps", "40"])


if __name__ == "__main__":
    raise SystemExit(main())
