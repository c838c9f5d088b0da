"""Async continuous-batching serving over a list of workers.

An :class:`repro_torch.runtime.AsyncEngine` front-end admits each request,
parks it in its padding bucket's batching window (flush on 64 graphs or a
15 ms deadline, whichever first), and a
:class:`repro_torch.runtime.BucketPlacer` routes distinct buckets to
distinct workers — two CUDA streams of one card (``cuda:0#0``,
``cuda:0#1``), or every card where there are two or more — each with its
own executable cache.  Per-request futures measure enqueue -> result
latency.  The workers serve the kernel tier.

    PYTHONPATH=src python -m repro_torch.examples.serve_async [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device, worker_devices
from repro_torch.graphs import TABLE4
from repro_torch.graphs.datasets import make_graph
from repro_torch.runtime import AsyncEngine, InferenceEngine, Request

DIMS = [(32, 16), (16, 8)]  # 2-layer GCN


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    dev = resolve_device(ap.parse_args(argv).device)

    rng = np.random.default_rng(0)
    names = ("mutag", "imdb-bin", "collab")
    requests = []
    for i in range(60):
        g = make_graph(TABLE4[names[i % 3]], rng)
        x = rng.normal(size=(g.n_nodes, 32)).astype(np.float32)
        requests.append(Request(graph=g, x=x, rid=i))

    params = InferenceEngine(DIMS, device=dev).init(
        torch.Generator().manual_seed(0))

    with AsyncEngine(DIMS, params, devices=worker_devices(dev),
                     window_ms=15.0, readout="mean",
                     use_pallas=True) as engine:
        engine.submit(requests)  # warm pass: builds land off the clock

        t0 = time.perf_counter()
        futures = [engine.submit_async(r) for r in requests]  # arrival stream
        results = [f.result() for f in futures]
        wall = time.perf_counter() - t0
        stats = engine.stats()

    ok = sum(r.ok for r in results)
    lat_ms = np.array([r.latency_s for r in results]) * 1e3  # enqueue -> result
    print(f"served {ok}/{len(results)} requests in {wall * 1e3:.0f} ms "
          f"({ok / wall:.0f} graphs/s) across {stats.n_devices} workers")
    print(f"per-request p50 {np.percentile(lat_ms, 50):.1f} ms / "
          f"p99 {np.percentile(lat_ms, 99):.1f} ms "
          f"(windows: {stats.n_flushes_full} full, "
          f"{stats.n_flushes_deadline} deadline)")
    print("bucket placement:")
    for bucket, devs in stats.placement.items():
        print(f"  {bucket:>8} -> {', '.join(devs)}")
    if ok != len(results):
        raise SystemExit(f"only {ok}/{len(results)} requests served")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
