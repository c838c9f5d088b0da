"""The readings that a cell's correctness limits are set from, on the card:

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--faults] [--out readings.jsonl]

In one process, at the cell's own size and load: for each seed the timed
path's answers through the cell's own call (every batch or snapshot once,
or the first training steps), held against the float32 reference (the
lower readings); for each control seed the reference computed one
precision below the configuration's type (TF32 for float32) in the
program's place (the control, which has to fail); with ``--faults``,
for a training cell, the reference with half of the labelled nodes left
out in the program's place.  One JSON line a reading.  The benchmark's
runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402


def readings_of(job, source: str) -> dict:
    r = job.readings(source)
    return {k: v for k, v in r.items() if isinstance(v, float)}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", action="store_true")
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    harness.prepare()
    import torch

    from repro_torch.runtime.store import ProgramStore

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.Benchmark()
    cell = bench.cell(args.workload)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    store = ProgramStore(harness.store_dir(harness.REPO), kernel_cache=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    seeds = list(dict.fromkeys(args.seeds + args.control_seeds))
    lines, job = [], None
    for seed in seeds:
        t = time.perf_counter()
        if job is None:
            job = harness.job_class(traffic["job"])(config, traffic, seed, dev, store)
            job.setup()
        else:
            job.reseed(seed)
        todo = []
        if seed in args.seeds:
            todo.append("program")
        if seed in args.control_seeds:
            todo.append("control")
            if args.faults and "half_batch" in job.sources:
                todo.append("half_batch")
        for source in todo:
            line = {"workload": args.workload, "seed": seed, "source": source,
                    **readings_of(job, source), "s": time.perf_counter() - t}
            print(json.dumps(line), flush=True)
            lines.append(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with args.out.open("a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    print(f"card: {harness.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
